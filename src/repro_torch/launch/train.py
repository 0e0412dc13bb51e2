"""Training launcher: an LM of the registry trained on the synthetic token
stream, with the trainer's full substrate (micro-batched step, int8 AdamW
option, atomic checkpoints, SIGTERM checkpointing, resume, straggler log).

Counterpart of ``repro/launch/train.py``: ``--data-axis`` and
``--model-axis`` make the (data, model) mesh (``launch/mesh.py``) over the
process group, a world of one unless a launcher started more ranks, and
the parameters' shardings by their logical axes, which a resume re-applies
(the identity on a world of one; a mesh larger than the world is
refused).  It feeds tokens only, as the reference's does, so an
encoder-decoder (whose batches carry frames) exits with an error that
names them; ``--device`` (default cuda), ``--depth`` (layers; default the
config's) and ``--dtype`` (the loss's compute dtype, fp32 masters either
way) are the port's own.  fp32 runs with TF32 off for matmuls and
convolutions.

  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      --smoke --device cpu --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch chatglm3-6b \\
      --int8-opt --steps 3 --batch 16 --seq 64 --grad-accum 2

The last line is a JSON summary: losses, step seconds, and on CUDA the
peak memory (``torch.cuda.max_memory_allocated``) and the kernels'
launch counts.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.sharding import param_sharding_tree
from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models.model import LM
from repro_torch.models.param import axes_tree
from repro_torch.training import (
    CheckpointManager,
    OptimizerConfig,
    TokenStream,
    TrainConfig,
    Trainer,
)


def parse_args(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="chatglm3-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=2)
    ap.add_argument("--int8-opt", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-axis", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--depth", type=int, default=None,
                    help="layers (default: the config's)")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.encoder_decoder:
        raise ValueError(f"{cfg.name}: an encoder-decoder trains on batches "
                         "with frames (B, T, d) beside the tokens, and the "
                         "launcher's TokenStream feeds tokens only; train it "
                         "with Trainer(lm.loss, ...) on batches that carry "
                         "frames")
    if args.depth is not None:
        cfg = cfg.replace(n_layers=args.depth)
    mesh = make_test_mesh(args.data_axis, args.model_axis, device=dev)
    shardings = param_sharding_tree(axes_tree(LM.spec(cfg)), mesh)
    dtype = getattr(torch, args.dtype)
    # a generator on the device: a full-width model is drawn on the card
    lm = LM(cfg, device=dev).init(torch.Generator(dev).manual_seed(0))
    data = TokenStream(cfg.vocab_size, args.batch, args.seq, device=dev)
    ckpt = CheckpointManager(args.ckpt_dir, device=dev) \
        if args.ckpt_dir else None
    trainer = Trainer(
        lambda batch: lm.loss(batch, dtype=dtype),
        dict(lm.named_parameters()),
        OptimizerConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps,
                        quantized_state=args.int8_opt),
        TrainConfig(steps=args.steps, grad_accum=args.grad_accum,
                    ckpt_every=max(args.steps // 4, 10)),
        data, ckpt, param_shardings=shardings)
    trainer.install_signal_handlers()
    if args.resume and trainer.restore():
        print(f"resumed from step {trainer.step}")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counts()
    out = trainer.train()
    print(f"done: step={out['step']} final_loss={out['final_loss']:.4f}")
    summary = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "device": str(dev), "dtype": args.dtype,
               "int8_opt": args.int8_opt,
               "batch": args.batch, "seq": args.seq,
               "grad_accum": args.grad_accum, "step": out["step"],
               "losses": out["history"], "step_s": out["step_times"]}
    if dev.type == "cuda":
        summary["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        summary["launches"] = {k: v for k, v in launch_counts().items() if v}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
    sys.exit(0)
