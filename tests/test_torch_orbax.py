"""The port's orbax reader (``train/orbax.py``, no orbax, tensorstore or
JAX in it) against the JAX package's ``restore_pytree`` on trees that the
JAX ``save_pytree`` and ``BestCheckpointPolicy`` write: nested dicts and
lists, every dtype the JAX package saves (bfloat16 through a uint16 view),
scalars and 0-d arrays, empty nodes, a dir saved twice with ``force=True``,
multi-chunk arrays with cut edge chunks, a store with interior b-tree nodes
(through tensorstore with small node limits), a save without OCDBT; values
bit for bit. The OCDBT parser against tensorstore's own reading of stores it
writes with other settings. A corrupt CRC and a zarr v3 save are refused.
The committed fixtures (``scripts/torch_orbax_fixtures.py``) read to the
hashes the JAX package recorded."""

import hashlib
import io
import json
import lzma
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import tensorstore as ts
import torch

from lyricalignment_tpu.train.checkpoints import BestCheckpointPolicy
from lyricalignment_tpu.train.checkpoints import restore_pytree as jax_restore
from lyricalignment_tpu.train.checkpoints import save_pytree
from lyricalignment_tpu.train.trainer import TrainConfig, init_train_state
from lyricalignment_tpu_torch.cli.common import load_model_dir
from lyricalignment_tpu_torch.train.checkpoints import restore_pytree
from lyricalignment_tpu_torch.train.orbax import (
    CheckpointFormatError,
    OcdbtStore,
    read_leaves,
)
from tests.torch_port_helpers import as_jax, jax_tiny_model

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_orbax")


def assert_same_tree(want, got, path="tree"):
    """JAX's restored tree against the port's: same containers, same
    dtypes and shapes, equal bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            assert_same_tree(want[k], got[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (w, g) in enumerate(zip(want, got)):
            assert_same_tree(w, g, f"{path}.{i}")
    elif want is None:
        assert got is None, path
    else:
        want = np.asarray(want)
        if want.dtype.name == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == want.shape, path
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16), err_msg=path)
        else:
            assert isinstance(got, np.ndarray), path
            assert got.dtype == want.dtype and got.shape == want.shape, path
            np.testing.assert_array_equal(got, want, err_msg=path)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "dense": {"w": rng.standard_normal((33, 17)).astype(np.float32),
                      "b": jnp.asarray(rng.standard_normal(17), jnp.bfloat16)},
            "blocks": [{"scale": rng.standard_normal(8).astype(np.float16)},
                       {"scale": rng.standard_normal(8).astype(np.float16)}],
        },
        "ints": [np.int32(-7), rng.integers(-9, 9, (3, 4)).astype(np.int32),
                 rng.integers(-2**40, 2**40, 5).astype(np.int64)],
        "mask": rng.random((2, 3)) < 0.5,
        "zero_d": np.array(2.5, np.float32),
        "scalars": (1.5, 7),
        "step": 0,
        "empty": {"d": {}, "l": [], "n": None},
    }


@pytest.mark.parametrize("case", ["dtypes", "saved_twice", "full_train_state", "no_ocdbt"])
def test_restore_equals_jax(tmp_path, case):
    path = str(tmp_path / "ckpt")
    if case == "dtypes":
        save_pytree(path, _tree())
    elif case == "saved_twice":
        save_pytree(path, _tree(0))
        save_pytree(path, _tree(1))  # force=True over the first
    elif case == "full_train_state":
        _, params = jax_tiny_model()
        state, _ = init_train_state(as_jax(params), TrainConfig(adam_mu_dtype=jnp.bfloat16))
        losses = {"total": 1.0, "align_ce": 1.0, "align_ctc": 0.0, "trans_ce": 1.0}
        with BestCheckpointPolicy(str(tmp_path), {**losses, "total": 2.0}) as policy:
            policy.update(losses, state.params, 0, full_state={
                "params": state.params, "opt_state": state.opt_state, "step": state.step})
        path = str(tmp_path / "best_model")
    else:
        ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_ocdbt=False)).save(
            path, _tree(), force=True)
        assert not os.path.exists(os.path.join(path, "manifest.ocdbt"))
    got = restore_pytree(path)
    assert_same_tree(jax_restore(path), got)
    if case == "saved_twice":
        np.testing.assert_array_equal(got["params"]["dense"]["w"], _tree(1)["params"]["dense"]["w"])


def _multi_chunk(path):
    tree = {"w": np.random.default_rng(3).standard_normal((37, 23)).astype(np.float32),
            "v": np.arange(1000, dtype=np.int64),
            "b": jnp.asarray(np.linspace(-3, 3, 301), jnp.bfloat16)}
    save_args = jax.tree_util.tree_map(lambda _: ocp.SaveArgs(chunk_byte_size=256), tree)
    ocp.PyTreeCheckpointer().save(path, tree, save_args=save_args, force=True)


def _ocdbt(path, config=None):
    """tensorstore's OCDBT key-value store at ``path``."""
    spec = {"driver": "ocdbt", "base": f"file://{path}/"}
    if config is not None:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _repack(src, dst, config):
    """The OCDBT store of checkpoint ``src`` rewritten into ``dst`` by
    tensorstore with ``config`` (small node limits make interior nodes)."""
    os.makedirs(dst)
    for f in ("_METADATA", "_CHECKPOINT_METADATA", "_sharding"):
        if os.path.exists(os.path.join(src, f)):
            shutil.copy(os.path.join(src, f), dst)
    old, new = _ocdbt(src), _ocdbt(dst, config)
    txn = ts.Transaction()
    for key in old.list().result():
        new.with_transaction(txn).write(key, old.read(key).result().value).result()
    txn.commit_async().result()


def test_multi_chunk_arrays_and_interior_nodes(tmp_path):
    src, dst = str(tmp_path / "chunks"), str(tmp_path / "repacked")
    _multi_chunk(src)
    with OcdbtStore(src) as store:
        meta = json.loads(store.get("w/.zarray"))
    assert meta["chunks"] != meta["shape"]  # several chunks, cut at the edges
    _repack(src, dst, {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16})
    manifest = ts.ocdbt.dump(ts.KvStore.open(f"file://{dst}/").result()).result()
    assert manifest["versions"][-1]["root_height"] >= 2
    for path in (src, dst):
        assert_same_tree(jax_restore(path), restore_pytree(path))


STORE_CONFIGS = {
    "defaults": {},
    "uncompressed": {"compression": None},
    "zstd_level_19": {"compression": {"id": "zstd", "level": 19}},
    "all_indirect": {"max_inline_value_bytes": 0, "max_decoded_node_bytes": 400},
    "small_nodes": {"max_decoded_node_bytes": 200},
}


@pytest.mark.parametrize("config", sorted(STORE_CONFIGS))
def test_ocdbt_reader_equals_tensorstore(tmp_path, config):
    """Keys and values of a store tensorstore writes in two commits
    (values inline and in data files, several data files), read back by
    the port's parser and by tensorstore."""
    rng = np.random.default_rng(7)
    store = _ocdbt(tmp_path, STORE_CONFIGS[config])
    for commit in range(2):
        txn = ts.Transaction()
        for i in range(40):
            value = rng.integers(0, 256, int(rng.integers(0, 90)), dtype=np.uint8).tobytes()
            store.with_transaction(txn).write(f"k/{commit}/{i:03d}", value).result()
        txn.commit_async().result()
    ref = _ocdbt(tmp_path)
    want = {k.decode(): ref.read(k).result().value for k in ref.list().result()}
    with OcdbtStore(str(tmp_path)) as got:
        assert got.keys() == sorted(want)
        for k, v in want.items():
            assert got.get(k) == v, k


@pytest.mark.parametrize("case", ["corrupt_crc", "zarr3", "numbered_manifest"])
def test_refused_with_a_message(tmp_path, case):
    """A corrupt manifest, a zarr v3 save and a numbered OCDBT manifest
    (which orbax does not write) raise ``CheckpointFormatError``."""
    path = str(tmp_path / "ckpt")
    if case == "zarr3":
        ocp.Checkpointer(ocp.PyTreeCheckpointHandler(use_zarr3=True)).save(
            path, _tree(), force=True)
        match = "use_zarr3"
    elif case == "corrupt_crc":
        save_pytree(path, _tree())
        manifest = os.path.join(path, "manifest.ocdbt")
        raw = bytearray(open(manifest, "rb").read())
        raw[20] ^= 1
        open(manifest, "wb").write(bytes(raw))
        match = "CRC-32C"
    else:
        save_pytree(path, _tree())
        shutil.rmtree(os.path.join(path, "ocdbt.process_0"))
        os.remove(os.path.join(path, "manifest.ocdbt"))
        _ocdbt(path, {"manifest_kind": "numbered"}).write("a", b"b").result()
        match = "manifest kind 1"
    with pytest.raises(CheckpointFormatError, match=match):
        restore_pytree(path)


def _leaf_sha(value) -> str:
    if isinstance(value, torch.Tensor):
        value = value.view(torch.int16).numpy()
    return hashlib.sha256(np.ascontiguousarray(value).tobytes()).hexdigest()


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def test_tiny_fixture_matches_its_record_and_pt():
    """The committed tiny full-state dir: every leaf's hash as JAX restored
    it, the model's state dict equal to JAX's ``export_reference_pt`` of
    the same weights, and the bfloat16 Adam ``mu`` read as bfloat16."""
    record = json.load(open(os.path.join(FIXTURES, "tiny.json")))
    tree = restore_pytree(os.path.join(FIXTURES, "tiny", "best_model"))
    got = {name: _leaf_sha(v) for name, v in _flat(tree)}
    assert got == {name: leaf["sha256"] for name, leaf in record["leaves"].items()}
    mu = tree["opt_state"][1]["inner_states"]["backbone"]["inner_state"][0]["mu"]
    assert mu["whisper"]["encoder"]["conv1"]["w"].dtype == torch.bfloat16
    _, model, _ = load_model_dir(os.path.join(FIXTURES, "tiny"), device="cpu")
    with lzma.open(os.path.join(FIXTURES, "tiny", "best_model.pt.xz")) as f:
        want = torch.load(io.BytesIO(f.read()), weights_only=True)
    sd = model.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert torch.equal(sd[k], v), k


def test_medium_fixture_structure_and_leaves():
    """The committed whisper-medium import dir: its leaves and shapes as
    recorded, and three leaves (the 212 MB token embedding among them) to
    their hashes. Its whole read is the chip run's."""
    record = json.load(open(os.path.join(FIXTURES, "medium.json")))["leaves"]
    meta = json.load(open(os.path.join(FIXTURES, "medium", "best_model", "_METADATA")))
    names = {".".join(k["key"] for k in e["key_metadata"]) for e in meta["tree_metadata"].values()}
    assert names == set(record) | {"step"}
    assert record["params.whisper.decoder.token_embedding"]["shape"] == [51865, 1024]
    want = ["params.whisper.decoder.token_embedding", "params.whisper.encoder.blocks.23.mlp_fc1.w",
            "params.align_head.fc.b"]
    got = read_leaves(os.path.join(FIXTURES, "medium", "best_model"), want)
    for name in want:
        assert list(got[name].shape) == record[name]["shape"], name
        assert _leaf_sha(got[name]) == record[name]["sha256"], name


def test_resume_from_jax_full_state_continues_jax(tmp_path, rng):
    """``restore_train_state`` (the train CLI's ``--resume``) from the full
    state the JAX trainer saved after one step (bf16 Adam mu): the port's
    parameters, count and step are JAX's, and its next step gives JAX's
    next losses (rtol 1e-5) and updates (within 2e-2 x lr, as
    tests/test_torch_trainer.py holds one step). The schedule continues
    from the stored count: restarted, the first update would be 10% larger
    (total_steps 10, no warmup), five times that tolerance."""
    from lyricalignment_tpu.train.trainer import TrainConfig as JaxTrainConfig
    from lyricalignment_tpu.train.trainer import TrainState as JaxTrainState
    from lyricalignment_tpu.train.trainer import make_train_step as jax_make_train_step
    from lyricalignment_tpu_torch.train.checkpoints import restore_train_state
    from lyricalignment_tpu_torch.train.trainer import TrainConfig as PortTrainConfig
    from lyricalignment_tpu_torch.train.trainer import init_train_state as port_init_state
    from lyricalignment_tpu_torch.train.trainer import make_train_step as port_make_train_step
    from tests.test_torch_trainer import TCFG, _batch, _jax_as_port, _jax_setup, _stack
    from tests.torch_port_helpers import torch_model

    cfg, params = _jax_setup(seed=2)
    kw = dict(TCFG, use_ctc=False)
    jtcfg = JaxTrainConfig(**kw, adam_mu_dtype=jnp.bfloat16)
    state, tx = init_train_state(as_jax(params), jtcfg)
    jax_step = jax_make_train_step(cfg, jtcfg, tx)
    batches = [jax.tree_util.tree_map(jnp.asarray, _stack([_batch(rng) for _ in range(2)]))
               for _ in range(2)]
    state, _ = jax_step(state, batches[0], jax.random.PRNGKey(0))
    losses = {"total": 1.0, "align_ce": 1.0, "align_ctc": 0.0, "trans_ce": 1.0}
    with BestCheckpointPolicy(str(tmp_path), {**losses, "total": 2.0}) as policy:
        policy.update(losses, state.params, 1, full_state={
            "params": state.params, "opt_state": state.opt_state, "step": state.step})
    path = str(tmp_path / "last_model")
    # JAX's --resume: a template restore, then the next step
    tree = jax_restore(path, {"params": state.params, "opt_state": state.opt_state,
                              "step": state.step})
    resumed = JaxTrainState(params=tree["params"], opt_state=tree["opt_state"],
                            step=jnp.asarray(tree["step"], jnp.int32))
    after, jlosses = jax_step(resumed, batches[1], jax.random.PRNGKey(0))
    before, after = _jax_as_port(resumed.params), _jax_as_port(after.params)
    adam = tree["opt_state"][1].inner_states["head"].inner_state[0]

    tcfg = PortTrainConfig(**kw, adam_mu_dtype=torch.bfloat16)
    model = torch_model(cfg, _jax_setup(seed=9)[1])  # other weights: all must be restored
    tstate, ttx = port_init_state(model, tcfg)
    restore_train_state(path, tstate)
    assert tstate.step == 1 and tstate.opt_state.count == 1
    for name, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), before[name], err_msg=name)
    mu_fc = tstate.opt_state.mu["align_rnn.fc.weight"]
    assert mu_fc.dtype == torch.bfloat16
    np.testing.assert_array_equal(mu_fc.float().numpy(),
                                  np.asarray(adam.mu["align_head"]["fc"]["w"], np.float32).T)
    tstate, plosses = port_make_train_step(tcfg, ttx)(
        tstate, jax.tree_util.tree_map(np.array, batches[1]))
    assert tstate.step == 2 and tstate.opt_state.count == 2
    for k in jlosses:
        np.testing.assert_allclose(float(plosses[k]), float(jlosses[k]), rtol=1e-5, err_msg=k)
    for name, p in model.named_parameters():
        lr = TCFG["head_lr"] if name.startswith("align_rnn.") else TCFG["backbone_lr"]
        got, want = p.detach().numpy() - before[name], after[name] - before[name]
        assert np.abs(got - want).max() <= 2e-2 * lr, name
        assert np.abs(got).max() > 0.5 * lr, name


def test_aligner_from_orbax_dir_equals_pt_dir(tmp_path):
    """``LyricAligner.from_model_dir`` (what ``cli.serve`` builds) on the
    committed tiny full-state dir aligns as on a ``.pt`` dir of the same
    weights."""
    from lyricalignment_tpu_torch.api import LyricAligner
    from lyricalignment_tpu_torch.data.audio_io import write_wav

    pt_dir = tmp_path / "pt"
    pt_dir.mkdir()
    for name in ("args.json", "model_args.json"):
        shutil.copy(os.path.join(FIXTURES, "tiny", name), pt_dir)
    with lzma.open(os.path.join(FIXTURES, "tiny", "best_model.pt.xz")) as f:
        (pt_dir / "best_model.pt").write_bytes(f.read())
    wav = str(tmp_path / "song.wav")
    write_wav(wav, (np.random.default_rng(1).standard_normal(2 * 16000) * 0.1)
              .astype(np.float32))
    got = [LyricAligner.from_model_dir(d, synthetic_vocab=True, device="cpu")
           .align_many([(wav, "你好世界")]) for d in (os.path.join(FIXTURES, "tiny"), str(pt_dir))]
    assert got[0] == got[1] and len(got[0][0]) == 4
