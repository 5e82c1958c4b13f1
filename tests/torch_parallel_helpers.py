"""Spawned gloo ranks for the port's scale-out tests
(tests/test_torch_parallel_*.py). Imports torch and the port only, so that
each spawned rank starts without JAX; the tests compute the JAX and
single-process references in their own process and hand the ranks numpy
weights and inputs."""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank, world, rdzv, out_dir, fn, payload):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}", rank=rank, world_size=world)
    try:
        result = fn(rank, world, payload)
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world: int, tmp_path, payload=None) -> list:
    """``fn(rank, world, payload)`` on ``world`` spawned processes joined
    over gloo through a ``file://`` rendezvous in ``tmp_path``; each rank's
    return value, in rank order."""
    out_dir = str(tmp_path)
    os.makedirs(out_dir, exist_ok=True)
    rdzv = os.path.join(out_dir, "rdzv")
    try:
        mp.spawn(_rank_main, args=(world, rdzv, out_dir, fn, payload), nprocs=world, join=True)
    except Exception as exc:
        errors = [open(os.path.join(out_dir, n)).read() for n in sorted(os.listdir(out_dir))
                  if n.startswith("error")]
        raise AssertionError("\n".join(errors) or str(exc)) from exc
    results = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# ---------------------------------------------------------------------------
# Shared stand-ins and model constructors
# ---------------------------------------------------------------------------

N_CLASSES = 12


class StubBert:
    def encode(self, text, add_special_tokens=False):
        return list(range(len(text)))


class StubTable:
    def map_tokens(self, ids):
        rng = np.random.default_rng(7)
        return rng.integers(1, N_CLASSES - 1, size=len(ids)).astype(np.int32)


class TinyTokenizer:
    """Whisper's special-token layout on a toy vocab (no BPE)."""

    eot, sot, lang_id, task_id = 20, 21, 22, 23
    sot_lm, sot_prev, no_speech, no_timestamps, timestamp_begin = 24, 25, 26, 27, 28
    n_vocab = 88
    language = "zh"
    has_bpe = False

    @property
    def sot_sequence(self):
        return [self.sot, self.lang_id, self.task_id]


def align_model(cfg, state_dict):
    """The port's AlignModel with ``state_dict`` (numpy or tensors), eval."""
    from lyricalignment_tpu_torch.models.align_model import AlignModel

    model = AlignModel(cfg)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()},
                          strict=True)
    return model.eval()


def whisper_model(cfg, state_dict):
    from lyricalignment_tpu_torch.models.whisper import Whisper

    model = Whisper(cfg)
    model.load_state_dict({k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()},
                          strict=True)
    return model.eval()


def numpy_dict(tensors):
    return {k: None if v is None else v.detach().cpu().numpy().copy()
            for k, v in tensors.items()}


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_mesh.py
# ---------------------------------------------------------------------------

def mesh_checks(rank, world, p):
    """On a (1 x 2) mesh: the shard -> gather round trip of a divisible and
    an indivisible model, the Megatron operators against autograd, the
    sequence-parallel encode and its refusals, the coordinate layout."""
    import torch.nn.functional as F

    from lyricalignment_tpu_torch.models.whisper import encode_audio
    from lyricalignment_tpu_torch.parallel import mesh as pm

    out = {}
    mesh = pm.make_mesh(data=1, model=2)
    out["coords"] = [tuple(mesh.get_coordinate()),
                     tuple(pm.make_mesh(data=-1, model=1).get_coordinate())]
    for key in ("div", "ind"):
        cfg, sd = p[key]
        model = align_model(cfg, sd)
        pm.shard_align_params(model, mesh)
        out[key] = {
            "specs": dict(model.shard_specs),
            "shapes": {k: tuple(v.shape) for k, v in model.state_dict().items()},
            "heads": [b.attn.n_head for b in model.whisper_model.encoder.blocks],
            "vocab_start": model.whisper_model.decoder.vocab_start,
            "gathered": numpy_dict(pm.gather_state_dict(model)),
        }

    x_np, w1, b1, w2, b2, g_out, g_gather = p["linear"]
    group = mesh.get_group(pm.MODEL_AXIS)
    h = w1.shape[0] // 2
    rows = slice(rank * h, (rank + 1) * h)
    x = torch.tensor(x_np, requires_grad=True)
    lw1 = torch.tensor(w1[rows], requires_grad=True)
    lb1 = torch.tensor(b1[rows], requires_grad=True)
    lw2 = torch.tensor(w2[:, rows], requires_grad=True)
    lb2 = torch.tensor(b2, requires_grad=True)
    y = F.gelu(F.linear(pm.copy_to_model(x, group), lw1, lb1))
    z = pm.reduce_from_model(F.linear(y, lw2), group) + lb2
    full = pm.gather_dim(y, -1, group)
    ((z * torch.tensor(g_out)).sum() + (full * torch.tensor(g_gather)).sum()).backward()
    out["fg"] = {"z": z.detach().numpy(), "full": full.detach().numpy(),
                 "dx": x.grad.numpy(), "dw1": lw1.grad.numpy(), "db1": lb1.grad.numpy(),
                 "dw2": lw2.grad.numpy(), "db2": lb2.grad.numpy()}

    wcfg, wsd, mel = p["sp"]
    whisper = whisper_model(wcfg, wsd)
    seq = pm.sequence_sharding(mesh)
    with torch.no_grad():
        out["sp"] = encode_audio(whisper, torch.tensor(mel), sequence_sharding=seq).numpy()
        refusals = []
        for cfg_, sd_, mel_ in ((wcfg, wsd, mel[..., :-2]), (*p["sp_heads3"], mel)):
            try:
                encode_audio(whisper_model(cfg_, sd_), torch.tensor(mel_), sequence_sharding=seq)
            except ValueError as exc:
                refusals.append(str(exc))
        out["sp_refusals"] = refusals
    try:
        encode_audio(whisper, torch.tensor(mel), sequence_sharding=seq)
    except ValueError as exc:
        out["sp_grad_refusal"] = str(exc)
    return out


def coordinates(rank, world, p):
    """(coordinate, data rank, model rank, group sizes) on a (2 x 2) mesh."""
    from lyricalignment_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(data=-1, model=2)
    bs = pm.batch_sharding(mesh)
    return (tuple(mesh.get_coordinate()), mesh.get_local_rank("data"),
            mesh.get_local_rank("model"), pm.axis_size(mesh, "data"),
            pm.axis_size(mesh, "model"), bs.rows(8))


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_infer.py
# ---------------------------------------------------------------------------

def align_args(batch_size=4, **mesh):
    from types import SimpleNamespace

    return SimpleNamespace(use_ctc_loss=True, is_mixture=0, bucket_seconds=4.0,
                           max_label_len=16, batch_size=batch_size, **mesh)


def align_segments(model, wavs, batch_size=4, **mesh):
    """The alignment CLI's ``align_records`` on the records of ``wavs``."""
    from lyricalignment_tpu_torch.cli.inference_alignment import align_records
    from lyricalignment_tpu_torch.data.records import Record

    records = [Record(audio_path=path, text="abcde") for path in wavs]
    return [seg for _, seg in align_records(records, model, StubTable(), StubBert(),
                                            align_args(batch_size, **mesh))]


def int8_model(cfg, sd):
    """The int8-encoder model as ``load_model_dir`` makes it: resident int8
    encoder weights."""
    from lyricalignment_tpu_torch.models.whisper import int8_resident

    model = align_model(cfg, sd)
    int8_resident(model.whisper_model)
    return model


def align_checks(rank, world, p):
    """Alignment under data=2 and model=2 (fp32, then the int8 encoder with
    resident and with per-call weights), and the divisibility exit."""
    from lyricalignment_tpu_torch.parallel.mesh import shard_whisper

    cfg, sd = p["fp32"]
    wavs = p["wavs"]
    out = {"data2": align_segments(align_model(cfg, sd), wavs, mesh_data=2),
           "model2": align_segments(align_model(cfg, sd), wavs, mesh_model=2)}
    model = int8_model(*p["int8"])
    out["int8_segments"] = align_segments(model, wavs, mesh_model=2)
    mesh = model.mesh
    mel = torch.tensor(p["mel"])
    with torch.no_grad():
        out["int8_resident"] = model.whisper_model.embed_audio(mel).numpy()
        dynamic = align_model(*p["int8"]).whisper_model   # weights quantised per call
        shard_whisper(dynamic, mesh)
        out["int8_dynamic"] = dynamic.embed_audio(mel).numpy()
    try:
        align_segments(align_model(cfg, sd), wavs[:2], batch_size=3, mesh_data=2)
    except SystemExit as exc:
        out["exit"] = str(exc)
    return out


def transcribe_tokens(whisper, wcfg, p, **mesh):
    from types import SimpleNamespace

    from lyricalignment_tpu_torch.cli.inference_transcript import transcribe_records
    from lyricalignment_tpu_torch.data.records import Record

    records = [Record(audio_path=path, text="") for path in p["tr_wavs"]]
    args = SimpleNamespace(is_mixture=0, batch_size=4, beam_size=2, max_new_tokens=8,
                           use_groundtruth=False, temperature_fallback=False,
                           fast_windows=False, length_penalty=None,
                           no_condition_on_previous_text=False, seed=0, **mesh)
    return [r["inference"] for r in transcribe_records(records, whisper, wcfg,
                                                        TinyTokenizer(), args)]


def align_transcribe_2x2(rank, world, p):
    """Alignment and transcription over a (2 x 2) mesh."""
    cfg, sd = p["fp32"]
    wcfg, wsd = p["whisper"]
    return {"align": align_segments(align_model(cfg, sd), p["wavs"], mesh_data=2,
                                    mesh_model=2),
            "tokens": transcribe_tokens(whisper_model(wcfg, wsd), wcfg, p,
                                        mesh_data=2, mesh_model=2)}


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_train.py
# ---------------------------------------------------------------------------

def train_results(cfg, sd, tcfg_kw, stacked, seed, mesh=None, eval_kw=None):
    """One ``make_train_step`` (its losses, the gradients the optimizer got
    gathered to full, the clip's norm and the norm of those gathered
    gradients, the parameters after) and the dropout-free losses of each
    micro-batch under ``tcfg_kw`` updated by ``eval_kw``, of the model
    ``cfg`` / ``sd`` (sharded over ``mesh`` when given: tensor-parallel when
    its model axis is 2)."""
    import dataclasses

    from lyricalignment_tpu_torch.parallel import mesh as pm
    from lyricalignment_tpu_torch.train.trainer import (
        LOSS_KEYS,
        TrainConfig,
        init_train_state,
        make_train_step,
        multitask_losses,
        to_device,
    )

    def build(c):
        model = align_model(c, sd)
        if mesh is not None:
            pm.shard_align_params(model, mesh, tp=pm.axis_size(mesh, pm.MODEL_AXIS) > 1)
        return model

    tcfg = TrainConfig(**tcfg_kw)
    model = build(cfg)
    state, tx = init_train_state(model, tcfg)
    seen = {}
    update = tx.update

    def spy(params, grads, opt_state):
        full = pm.gather_tensors(model, grads)
        seen["grads"] = numpy_dict(full)
        seen["norm"] = float(tx.global_norm(grads))
        seen["full_norm"] = float(torch.linalg.vector_norm(torch.stack(
            [g.double().norm() for g in full.values() if g is not None])))
        return update(params, grads, opt_state)

    tx.update = spy
    _, losses = make_train_step(tcfg, tx, mesh)(state, stacked, seed)
    out = dict(seen, losses={k: float(v) for k, v in losses.items()},
               after=numpy_dict(pm.gather_state_dict(model)))

    # the losses without dropout, each micro-batch's (JAX's eval step)
    model = build(dataclasses.replace(cfg, dropout=0.0))
    tcfg = TrainConfig(**dict(tcfg_kw, **(eval_kw or {})))
    data_group = None if mesh is None else mesh.get_group(pm.DATA_AXIS)
    rows = None if mesh is None else pm.batch_sharding(mesh)
    out["eval"] = []
    with torch.no_grad():
        for i in range(tcfg.accum_grad_steps):
            micro = {k: v[i] if rows is None else rows.shard(v[i]) for k, v in stacked.items()}
            _, ls = multitask_losses(model, tcfg, to_device(micro, "cpu"), None, data_group)
            ls = torch.stack([ls[k] for k in LOSS_KEYS])
            if data_group is not None:
                dist.all_reduce(ls, group=data_group)
            out["eval"].append(dict(zip(LOSS_KEYS, ls.tolist())))
    return out


def train_checks(rank, world, p):
    """``train_results`` on each mesh shape of ``p["meshes"]``."""
    from lyricalignment_tpu_torch.parallel.mesh import make_mesh

    return {shape: train_results(p["cfg"], p["sd"], p["tcfg"], p["stacked"], p["seed"],
                                 make_mesh(*shape), p["eval_kw"])
            for shape in p["meshes"]}


def train_cli(rank, world, p):
    """``cli.train_multitask.main(p["argv"])`` with the miniature backbone
    registered as "tiny"; returns what the rank printed."""
    import contextlib
    import io

    from lyricalignment_tpu_torch.cli.train_multitask import main
    from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS

    WHISPER_CONFIGS["tiny"] = p["tiny"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(p["argv"])
    return buf.getvalue()


# ---------------------------------------------------------------------------
# tests/test_torch_parallel_pipeline.py
# ---------------------------------------------------------------------------

def grads_of(module, mesh, prefix):
    """The full gradients of ``module``'s parameters named ``prefix*`` on
    every rank: a stage's gathered from its owner (``gather_tensors``), then
    every entry summed over the data group."""
    from lyricalignment_tpu_torch.parallel import mesh as pm

    local = {n: torch.empty_like(p) if p.is_meta else
             (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in module.named_parameters() if n.startswith(prefix)}
    full = pm.gather_tensors(module, local)
    for g in full.values():
        dist.all_reduce(g, group=mesh.get_group(pm.DATA_AXIS))
    return numpy_dict(full)


def block_bytes(whisper, sides=("encoder", "decoder")):
    """Bytes of the resident block parameters of a Whisper's ``sides``."""
    return sum(p.numel() * p.element_size() for n, p in whisper.named_parameters()
               if n.split(".")[0] in sides and n.split(".")[1] == "blocks" and not p.is_meta)


def step_results(model, tcfg, stacked, seed, mesh=None, encode_fn=None, decode_fn=None,
                 steps=1, state=None):
    """``steps`` updates of ``make_train_step``: the last step's losses,
    the clip's norm, the gradients it clipped (gathered, summed over the data
    group by the step itself), the full parameters after, and the state."""
    from lyricalignment_tpu_torch.parallel import mesh as pm
    from lyricalignment_tpu_torch.train.trainer import init_train_state, make_train_step

    if state is None:
        state, tx = init_train_state(model, tcfg)
    else:
        state, tx = state
    seen = {}
    update = tx.update

    def spy(params, grads, opt_state):
        seen["norm"] = float(tx.global_norm(grads))
        local = {n: torch.empty_like(p) if p.is_meta else
                 (grads[n] if grads.get(n) is not None else torch.zeros_like(p))
                 for n, p in model.named_parameters()}
        seen["grads"] = numpy_dict(pm.gather_tensors(model, local))
        return update(params, grads, opt_state)

    tx.update = spy
    step = make_train_step(tcfg, tx, mesh, encode_fn, decode_fn)
    for _ in range(steps):
        _, losses = step(state, stacked, seed)
    tx.update = update
    return dict(seen, losses={k: float(v) for k, v in losses.items()},
                after=numpy_dict(pm.gather_state_dict(model))), (state, tx)


def staged_align_model(cfg, sd, mesh):
    """An AlignModel with both halves staged over ``mesh``."""
    from lyricalignment_tpu_torch.parallel import mesh as pm
    from lyricalignment_tpu_torch.parallel import pipeline as pp

    model = align_model(cfg, sd)
    pm.shard_align_params(model, mesh, tp=False)
    return pp.stage_align_params(model, mesh, ("encoder", "decoder"))


def pipe_train(p, mesh, tmp=None):
    """The pipelined train step of ``p["train"]`` on ``mesh`` with both
    halves staged; with ``tmp``, its checkpoint is written there, restored
    onto a freshly staged model and trained one more step."""
    from lyricalignment_tpu_torch.parallel import pipeline as pp
    from lyricalignment_tpu_torch.train.checkpoints import restore_train_state, save_train_state
    from lyricalignment_tpu_torch.train.trainer import TrainConfig, init_train_state

    cfg, sd, tcfg_kw, stacked, seed = p["train"]
    tcfg = TrainConfig(**tcfg_kw)
    fns = (pp.make_pipeline_encode_fn(mesh, 2), pp.make_pipeline_logits_fn(mesh, 2))
    model = staged_align_model(cfg, sd, mesh)
    out, state = step_results(model, tcfg, stacked, seed, mesh, *fns)
    out["bytes"] = block_bytes(model.whisper_model)
    if tmp is not None:
        save_train_state(os.path.join(tmp, "last_model"), state[0])
        dist.barrier()
        model = staged_align_model(cfg, sd, mesh)
        resumed = init_train_state(model, tcfg)
        restore_train_state(os.path.join(tmp, "last_model"), resumed[0])
        out["resumed_step"] = resumed[0].step
        out["second"], _ = step_results(model, tcfg, stacked, seed, mesh, *fns, state=resumed)
    return out


def _encoder_cases(p, mesh, rows, out, tag):
    """The pipelined encoder forward (n_micro 1 and 2) and the gradients of
    sum(y ** 2) with and without remat on ``mesh``."""
    from lyricalignment_tpu_torch.parallel import pipeline as pp

    wcfg, sd, mel = p["enc"]
    mel = torch.tensor(rows.shard(mel))
    model = whisper_model(wcfg, sd)
    pp.stage_whisper(model, mesh)
    with torch.no_grad():
        for n_micro in (1, 2):
            out[f"{tag}_m{n_micro}"] = pp.pipeline_encode_audio(model, mel, mesh,
                                                                n_micro).numpy()
    for remat in (False, True):
        model = whisper_model(wcfg, sd)
        pp.stage_whisper(model, mesh)
        (pp.pipeline_encode_audio(model, mel, mesh, 2, remat=remat) ** 2).sum().backward()
        out[f"{tag}_grads_remat{remat}"] = grads_of(model, mesh, "encoder.")


def _decoder_cases(p, mesh, rows, out, tag):
    """The pipelined decoder's logits, and the gradients of mean(logits **
    2) over the global batch wrt the parameters and xa, with and without
    remat."""
    from lyricalignment_tpu_torch.parallel import pipeline as pp

    wcfg, sd, tokens, xa = p["dec"]
    n_total = tokens.shape[0] * tokens.shape[1] * wcfg.n_vocab
    for remat in (False, True):
        model = whisper_model(wcfg, sd)
        pp.stage_whisper(model, mesh, ("decoder",))
        a = torch.tensor(rows.shard(xa), requires_grad=True)
        logits = pp.pipeline_decoder_logits(model, torch.tensor(rows.shard(tokens)), a, mesh, 2,
                                            remat=remat)
        ((logits ** 2).sum() / n_total).backward()
        out[f"{tag}_logits"] = logits.detach().numpy()
        out[f"{tag}_grads_remat{remat}"] = grads_of(model, mesh, "decoder.")
        out[f"{tag}_dxa_remat{remat}"] = a.grad.numpy()


def pipe_checks_world4(rank, world, p):
    """Four ranks: DP2 x PP2 (encoder, pre-stacked blocks, decoder, the
    train step with both halves staged, the alignment CLI with an even and
    an odd local batch), a pure pipe mesh of 4 (encoder), and the
    refusals."""
    from lyricalignment_tpu_torch.models.whisper import encode_audio
    from lyricalignment_tpu_torch.parallel import mesh as pm
    from lyricalignment_tpu_torch.parallel import pipeline as pp

    out = {}
    mesh = pm.make_mesh(data=2, model=2)
    rows = pm.batch_sharding(mesh)
    _encoder_cases(p, mesh, rows, out, "dp2pp2")
    wcfg, sd, mel = p["enc"]
    full = whisper_model(wcfg, sd)
    stacked = pp.place_pipeline_params(pp.stack_encoder_blocks(full.encoder.blocks, 2), mesh)
    with torch.no_grad():
        out["prestacked"] = pp.pipeline_encode_audio(full, torch.tensor(rows.shard(mel)), mesh,
                                                     2, stacked=stacked).numpy()
    _decoder_cases(p, mesh, rows, out, "dec_dp2pp2")
    out["train"] = pipe_train(p, mesh)

    acfg, asd, wavs = p["align"]
    out["align"] = align_segments(align_model(acfg, asd), wavs, mesh_data=2, mesh_pipe=2)
    out["align_odd"] = align_segments(align_model(acfg, asd), wavs, batch_size=6, mesh_data=2,
                                      mesh_pipe=2)

    pure = pm.make_mesh(data=1, model=4)
    _encoder_cases(p, pure, pm.batch_sharding(pure), out, "pp4")
    model = whisper_model(wcfg, sd)
    pp.stage_whisper(model, pure)
    out["pp4_bytes"] = block_bytes(model, ("encoder",))

    refusals = []
    model = whisper_model(wcfg, sd)
    pp.stage_whisper(model, mesh)
    for call in (lambda: pp.pipeline_encode_audio(model, torch.tensor(mel[:3]), mesh, 2),
                 lambda: encode_audio(model, torch.tensor(mel),
                                      sequence_sharding=pm.sequence_sharding(mesh))):
        try:
            with torch.no_grad():
                call()
        except ValueError as exc:
            refusals.append(str(exc))
    out["refusals"] = refusals
    return out


def pipe_checks_world2(rank, world, p):
    """Two ranks, a pure pipe mesh (the card's layout): the encoder with 2
    layers a stage, the decoder, and the train step with both halves
    staged, its checkpoint written, restored and trained a second step."""
    from lyricalignment_tpu_torch.parallel import mesh as pm
    from lyricalignment_tpu_torch.parallel import pipeline as pp

    out = {}
    mesh = pm.make_mesh(data=1, model=2)
    rows = pm.batch_sharding(mesh)
    _encoder_cases(p, mesh, rows, out, "pp2")
    _decoder_cases(p, mesh, rows, out, "dec_pp2")
    out["train"] = pipe_train(p, mesh, p["tmp"])
    return out
