"""The port's observability layer (``utils/observability.py``, the
counterpart of ``lyricalignment_tpu/utils/observability.py``): a profile
written by ``profile_session`` holds the ``trace`` and ``annotate`` spans
run inside it; ``MetricLogger`` writes the JAX logger's JSONL rows always
and, with ``tensorboard=True``, TensorBoard scalars under ``tb/``."""

import json

import pytest
import torch

from lyricalignment_tpu.utils import observability as jax_obs
from lyricalignment_tpu_torch.utils import observability as obs


def test_profile_session_records_the_spans(tmp_path):
    add = obs.annotate(lambda a, b: a + b, "add_step")
    assert add.__name__ == "<lambda>"
    with obs.profile_session(str(tmp_path / "profile")):
        with obs.trace("data"):
            x = torch.ones(8)
        with obs.trace("train_step"):
            y = add(x, x)
    assert float(y.sum()) == 16.0
    events = json.loads((tmp_path / "profile" / obs.TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"data", "train_step", "add_step"} <= names


def test_trace_outside_a_session_is_a_no_op():
    with obs.trace("outside"):
        pass


@pytest.mark.parametrize("tensorboard", [False, True])
def test_metric_logger_rows_match_jax(tmp_path, tensorboard):
    """The same rows as the JAX logger (step and metrics; the clock fields
    differ), and the tb/ event file only with ``tensorboard``."""
    metrics = [(1, {"total": 2.5, "align_ce": 1.25}), (2, {"total": 2.0, "align_ce": 1.0})]
    for mod, d in ((obs, tmp_path / "port"), (jax_obs, tmp_path / "jax")):
        logger = mod.MetricLogger(str(d), tensorboard=False if mod is jax_obs else tensorboard)
        for step, m in metrics:
            logger.log(step, m)
        logger.close()
    rows = {}
    for name in ("port", "jax"):
        lines = (tmp_path / name / "metrics.jsonl").read_text().splitlines()
        rows[name] = [{k: v for k, v in json.loads(l).items() if k not in ("time", "wall_s")}
                      for l in lines]
    assert rows["port"] == rows["jax"] == [{"step": s, **m} for s, m in metrics]
    events = list((tmp_path / "port" / "tb").glob("events.out.tfevents.*"))
    assert bool(events) == tensorboard
    if tensorboard:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(str(tmp_path / "port" / "tb"))
        acc.Reload()
        assert [e.value for e in acc.Scalars("total")] == [2.5, 2.0]
