"""Multitask training CLI.

Port of ``lyricalignment_tpu/cli/train_multitask.py:56-315`` (the
reference's ``train_multitask.py:29-143,635-730``): the same data, model and
training flags and the same main loop — initial eval, then N steps of
accumulated micro-batches, eval every ``--eval-steps``, best/last
checkpoints — on one device (``--device cuda`` by default; ``cpu`` runs the
kernels' plain versions). ``--resume dir/last_model`` continues from a
checkpoint's weights, optimizer state and step.

``--fused-losses`` computes the align losses from the head's hidden and
its fc (no [B, T, C] logits); ``--tensorboard`` adds TensorBoard scalars
beside ``metrics.jsonl``; ``--profile-at-step N`` writes a profile of step N
(``torch.profiler``, host spans ``data`` and ``train_step`` and the device's
kernels) to ``save_dir/profile/trace.json``.

``--mesh-data`` / ``--mesh-model`` train over a ("data", "model") mesh of
torchrun ranks (``parallel.mesh``): every rank builds the same seeded model
and the same global stacked batch, takes its data rank's rows (the train
batch size must divide the data axis), runs the backbone tensor-sharded over
the model axis and sums the gradients over the data group
(``train/trainer.py``); only rank 0 writes metrics, TensorBoard scalars,
profiles and checkpoints, which hold the full state gathered from the
shards, so a model dir written under any mesh loads unsharded and
``--resume`` re-shards it. The dev set is evaluated whole on every data
rank. ``--mesh-pipe N`` stages the encoder over the model axis instead, and
the teacher-forced decoder too when it trains the transcript task
(``parallel.pipeline``: GPipe with ``--pipe-microbatches`` micro-batches of
a data rank's rows; each rank holds and updates its stage's blocks and the
replicated rest).

Example:
    python -m lyricalignment_tpu_torch.cli.train_multitask \\
        --train-data train.json --dev-data dev.json \\
        --whisper-model medium --train-alignment --train-transcript \\
        --use-ctc-loss --bert-vocab vocab.txt --save-dir result --bf16
    python -m torch.distributed.run --nproc-per-node 4 \\
        -m lyricalignment_tpu_torch.cli.train_multitask ... \\
        --train-batch-size 4 --mesh-data 2 --mesh-model 2
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m lyricalignment_tpu_torch.cli.train_multitask ... --mesh-pipe 2
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from lyricalignment_tpu_torch.cli.common import (
    add_asset_args,
    add_mesh_args,
    build_model_config,
    build_tokenizers,
    init_distributed,
    init_model,
    model_mesh,
    resolve_device,
    set_seed,
)
from lyricalignment_tpu_torch.data.pipeline import (
    MultitaskExampleBuilder,
    MultitaskLoader,
    PipelineConfig,
    infinite_batches,
)
from lyricalignment_tpu_torch.data.records import read_many
from lyricalignment_tpu_torch.models.whisper import WHISPER_CONFIGS
from lyricalignment_tpu_torch.parallel.mesh import is_primary, shard_align_params
from lyricalignment_tpu_torch.parallel.pipeline import (
    make_pipeline_encode_fn,
    make_pipeline_logits_fn,
)
from lyricalignment_tpu_torch.text.pinyin import load_pronunciation_table
from lyricalignment_tpu_torch.text.whisper_tokenizer import num_languages_for_vocab
from lyricalignment_tpu_torch.train.checkpoints import (
    BestCheckpointPolicy,
    restore_train_state,
    save_json,
)
from lyricalignment_tpu_torch.train.trainer import (
    TrainConfig,
    evaluate,
    init_train_state,
    make_eval_step,
    make_train_step,
    stack_microbatches,
)
from lyricalignment_tpu_torch.utils.observability import MetricLogger, profile_session, trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--train-data", nargs="+", type=str, required=True)
    p.add_argument("--dev-data", nargs="+", type=str, required=True)
    p.add_argument("--whisper-model", default="medium", choices=sorted(WHISPER_CONFIGS))
    p.add_argument("--train-alignment", action="store_true")
    p.add_argument("--train-transcript", action="store_true")
    p.add_argument("--is-mixture", type=int, choices=[0, 1, 2], default=0)
    p.add_argument("--train-batch-size", type=int, default=2)
    p.add_argument("--dev-batch-size", type=int, default=8)
    p.add_argument("--accum-grad-steps", type=int, default=8)
    p.add_argument("--freeze-encoder", action="store_true")
    p.add_argument("--use-ctc-loss", action="store_true")
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--backbone-lr", type=float, default=5e-6)
    p.add_argument("--max-grad-norm", type=float, default=1.0)
    p.add_argument("--train-steps", type=int, default=2000)
    p.add_argument("--eval-steps", type=int, default=200)
    p.add_argument("--warmup-steps", type=int, default=200)
    p.add_argument("--save-dir", type=str, default="result")
    p.add_argument("--save-all-checkpoints", action="store_true")
    p.add_argument("--seed", type=int, default=114514)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--fast-gelu", action="store_true",
                   help="tanh-approximate GELU in the encoder stem and every MLP")
    p.add_argument("--remat", action="store_true",
                   help="checkpoint every transformer block (recompute in backward)")
    p.add_argument("--bf16-grad-accum", action="store_true",
                   help="accumulate micro-batch gradients in bf16")
    p.add_argument("--bf16-adam-mu", action="store_true",
                   help="store Adam's first moment in bf16")
    p.add_argument("--fused-losses", action="store_true",
                   help="align losses from the head's hidden and fc: the row LSE "
                        "and reduced CTC kernels, no [B, T, C] logits")
    p.add_argument("--max-label-len", type=int, default=128)
    p.add_argument("--max-decoder-len", type=int, default=160)
    p.add_argument("--log-every", type=int, default=1,
                   help="write metrics every N steps (a device sync per write)")
    p.add_argument("--tensorboard", action="store_true",
                   help="TensorBoard scalars in save_dir/tb (needs the tensorboard package)")
    p.add_argument("--profile-at-step", type=int, default=0,
                   help="profile this step (0: none) into save_dir/profile/trace.json")
    p.add_argument("--resume", type=str, default=None,
                   help="checkpoint (e.g. result/last_model) to resume weights, "
                        "optimizer state and step from; the schedule continues")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (plain PyTorch versions of the kernels)")
    add_mesh_args(p, "each micro-batch", pipe=True)
    p.add_argument("--pipe-microbatches", type=int, default=2,
                   help="pipeline micro-batches per data shard")
    add_asset_args(p)
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    meshed = bool(args.mesh_data) or args.mesh_model > 1 or args.mesh_pipe > 1
    device = init_distributed(args.device) if meshed else resolve_device(args.device)
    primary = is_primary()
    set_seed(args.seed)
    os.makedirs(args.save_dir, exist_ok=True)
    if primary:
        save_json(os.path.join(args.save_dir, "args.json"), vars(args))

    bert, whisper_tok = build_tokenizers(
        args, num_languages=num_languages_for_vocab(WHISPER_CONFIGS[args.whisper_model].n_vocab))
    table = load_pronunciation_table()

    output_dim = len(bert) + int(args.use_ctc_loss)
    mcfg = build_model_config(
        args.whisper_model, output_dim=output_dim, use_bf16=args.bf16,
        freeze_encoder=args.freeze_encoder, train_alignment=args.train_alignment,
        train_transcript=args.train_transcript, fast_gelu=args.fast_gelu)
    model_args = {
        "embed_dim": mcfg.whisper.n_audio_state,
        "hidden_dim": mcfg.hidden_dim,
        "output_dim": output_dim,
        "bidirectional": True,
        "freeze_encoder": args.freeze_encoder,
        "train_alignment": args.train_alignment,
        "train_transcript": args.train_transcript,
    }
    if primary:
        print(model_args)
        save_json(os.path.join(args.save_dir, "model_args.json"), model_args)

    tcfg = TrainConfig(
        head_lr=args.lr, backbone_lr=args.backbone_lr, warmup_steps=args.warmup_steps,
        total_steps=args.train_steps, max_grad_norm=args.max_grad_norm,
        accum_grad_steps=args.accum_grad_steps, use_ctc=args.use_ctc_loss,
        vocab_size=len(bert), remat=args.remat, seed=args.seed,
        grad_accum_dtype=torch.bfloat16 if args.bf16_grad_accum else None,
        adam_mu_dtype=torch.bfloat16 if args.bf16_adam_mu else None,
        fused_losses=args.fused_losses, freeze_encoder=args.freeze_encoder)

    def loader(paths, batch_size, train):
        pcfg = PipelineConfig(batch_size=batch_size, use_ctc=args.use_ctc_loss,
                              audio_type=args.is_mixture, max_label_len=args.max_label_len,
                              max_decoder_len=args.max_decoder_len, drop_remainder=train)
        builder = MultitaskExampleBuilder(bert, whisper_tok, table, pcfg)
        return MultitaskLoader(read_many(*paths), builder, shuffle=train, seed=args.seed)

    train_loader = loader(args.train_data, args.train_batch_size, True)
    dev_loader = loader(args.dev_data, args.dev_batch_size, False)

    model = init_model(args, mcfg, args.seed, device)
    if args.freeze_encoder and args.bf16:
        # a frozen encoder never updates, so its matmul weights can live in
        # bf16 as on the inference path (identical under bf16 compute)
        for p in model.whisper_model.encoder.parameters():
            if p.dim() >= 2:
                p.data = p.data.to(torch.bfloat16)
    mesh = model_mesh(model, args, device, shard_align_params, args.train_batch_size)
    encode_fn = decode_fn = None
    if mesh is not None:
        log(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    if args.mesh_pipe > 1:
        encode_fn = make_pipeline_encode_fn(mesh, n_micro=args.pipe_microbatches)
        staged = "encoder"
        if mcfg.train_transcript:
            decode_fn = make_pipeline_logits_fn(mesh, n_micro=args.pipe_microbatches)
            staged = "encoder+decoder"
        log(f"pipeline-parallel {staged}: {args.mesh_pipe} stages x "
            f"{args.pipe_microbatches} microbatches")
    state, tx = init_train_state(model, tcfg)
    if args.resume:
        restore_train_state(args.resume, state)
        log(f"resumed from {args.resume} at step {state.step}")
    start_step = state.step
    train_step = make_train_step(tcfg, tx, mesh, encode_fn, decode_fn)
    eval_step = make_eval_step(tcfg, encode_fn, decode_fn)

    init_losses = evaluate(eval_step, model, dev_loader)
    log(f"Initial loss: {init_losses['total']:.4f}, "
        f"align CE: {init_losses['align_ce']:.4f}, "
        f"align CTC: {init_losses['align_ctc']:.4f}, "
        f"transcript: {init_losses['trans_ce']:.4f}, "
        f"transcript CTC: {init_losses['trans_ctc']:.4f}")
    policy = BestCheckpointPolicy(args.save_dir, init_losses)
    metrics = MetricLogger(args.save_dir, tensorboard=args.tensorboard) if primary else None
    train_iter = infinite_batches(train_loader)
    avg = {k: 0.0 for k in init_losses}
    t_start = time.time()
    profiling = None

    for step in range(start_step + 1, args.train_steps + 1):
        if args.profile_at_step and step == args.profile_at_step and primary:
            profiling = profile_session(os.path.join(args.save_dir, "profile"))
            profiling.__enter__()
        with trace("data"):
            stacked = stack_microbatches(
                [next(train_iter) for _ in range(args.accum_grad_steps)])
        with trace("train_step"):
            state, losses = train_step(state, stacked, args.seed)
        if profiling is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # the step's device work inside the profile
            profiling.__exit__(None, None, None)
            profiling = None
        losses = {k: float(v) for k, v in losses.items()}
        if step % args.log_every == 0 and metrics is not None:
            metrics.log(step, losses)
        for k in avg:
            avg[k] += losses[k]

        if step % args.eval_steps == 0:
            eval_losses = evaluate(eval_step, model, dev_loader)
            n = args.eval_steps
            log(f"Step {step}: valid loss={eval_losses['total']:.4f} "
                f"align_ce={eval_losses['align_ce']:.4f} "
                f"align_ctc={eval_losses['align_ctc']:.4f} "
                f"trans_ce={eval_losses['trans_ce']:.4f} "
                f"trans_ctc={eval_losses['trans_ctc']:.4f} | "
                f"train loss={avg['total'] / n:.4f} "
                f"({(time.time() - t_start) / (step - start_step):.2f}s/step)")
            avg = {k: 0.0 for k in avg}
            saved = policy.update(eval_losses, state, save_all=args.save_all_checkpoints)
            for name, fired in saved.items():
                if fired:
                    log(f"Saving The {name} model")

    if metrics is not None:
        metrics.close()
    log(f"done in {time.time() - t_start:.1f}s")


def log(msg: str) -> None:
    """Print on rank 0 (every process outside a distributed run)."""
    if is_primary():
        print(msg)


if __name__ == "__main__":
    main()
