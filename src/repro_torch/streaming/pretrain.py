"""Train the streaming operator models on the synthetic labeled streams.

Counterpart of ``repro/streaming/pretrain.py``.  Produces (and caches) the
OpContext every plan runs with:
  * big StreamMLLM  — trained supervised on mixed preprocessing configs
    (full frame / crop / crop+downscale) so it stays accurate under any plan;
  * small StreamMLLM — *distilled* from the big one's logits on the
    optimized preprocessing (the paper's model-specialization path; the
    teacher runs under ``inference_mode``: the forward kernel alone);
  * pruned model     — structured FFN pruning of the big model
    (adaptive pruning's static half; rate selection is runtime);
  * TinyDet          — the cascade detector.

This is the offline "super-optimization pays off because queries are
long-running" investment the paper argues for.  On a CUDA device every
MLLM step runs the flash_attention forward kernel with its log-sum-exp and
its backward kernel (``kernels/flash_attention/ops.py``).

The cache is the port's own, ``.cache/stream_models_torch/``, never the
reference's ``.cache/stream_models/``: the reference stores conv kernels
HWIO and the port OIHW, so a cross-read would load wrong weights without a
word.  The manifest names the package that wrote it, and a cache another
package wrote is refused.
"""
from __future__ import annotations

import os
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import flatten
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.core.physical import structured_prune
from repro_torch.data.tollbooth import (BRANDS, COLORS, PLATE_CHARS,
                                        TollBoothStream)
from repro_torch.data.volleyball import ACTIONS, VolleyballStream
from repro_torch.streaming.detector import TinyDet
from repro_torch.streaming.mllm import PLATE_LEN, StreamMLLM
from repro_torch.streaming.operators import OpContext
from repro_torch.training.checkpoint import PACKAGE, CheckpointManager, nest
from repro_torch.training.optimizer import OptimizerConfig, adamw_init
from repro_torch.training.trainer import make_train_step

CACHE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                         ".cache", "stream_models_torch")

PATCH = 16
CROP = (64, 0, 64, 256)      # road region

Batch = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# label encoding
# ---------------------------------------------------------------------------

def encode_tollbooth_labels(labels) -> Dict[str, np.ndarray]:
    n = len(labels)
    out = {
        "present": np.zeros(n, np.int32),
        "color": np.zeros(n, np.int32),
        "brand": np.zeros(n, np.int32),
        "plate": np.zeros((n, PLATE_LEN), np.int32),
        "mask_car": np.zeros(n, np.float32),
    }
    for i, l in enumerate(labels):
        out["present"][i] = int(bool(l["car_present"]))
        if l.get("car_readable"):
            out["mask_car"][i] = 1.0
            out["color"][i] = COLORS.index(l["color"])
            out["brand"][i] = BRANDS.index(l["brand"])
            out["plate"][i] = [PLATE_CHARS.index(c) for c in l["plate"]]
    return out


def encode_volleyball_labels(labels) -> Dict[str, np.ndarray]:
    return {
        "action": np.asarray([ACTIONS.index(l["action"]) for l in labels],
                             np.int32),
        "n_jumping": np.asarray([min(l["n_jumping"], 6) for l in labels],
                                np.int32),
        "team": np.asarray([l["attack_team"] for l in labels], np.int32),
    }


def preprocess_np(frames: np.ndarray, crop=None, factor: int = 1
                  ) -> np.ndarray:
    x = frames.astype(np.float32)
    if crop is not None:
        y0, x0, h, w = crop
        x = x[:, :, y0:y0 + h, x0:x0 + w]
    if factor > 1:
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // factor, factor, w // factor, factor
                      ).mean(axis=(3, 5))
    return (x / 255.0 - 0.5) / 0.25


def _to_device(arrays: Mapping[str, np.ndarray], device) -> Batch:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# training loops
# ---------------------------------------------------------------------------

def _train(model_loss: Callable[[Batch], torch.Tensor],
           params: Mapping[str, torch.Tensor], batches: Callable[[int], Batch],
           steps: int, lr: float = 1e-3, log_every: int = 50,
           label: str = "") -> Tuple[Mapping[str, torch.Tensor], list]:
    """``steps`` AdamW steps of ``model_loss`` over ``batches(i)``,
    updating ``params`` (a module's named parameters) in place; grad is on
    for them only while training.  Returns (params, per-step losses)."""
    if os.environ.get("REPRO_CAST_BF16_STEP") == "1":
        raise NotImplementedError(
            "REPRO_CAST_BF16_STEP: the bf16 step casts the LM's weights "
            "(models/model.py, models/blocks.py); the stream models' layers "
            "do not take the cast, so they pretrain in fp32 only: unset it")
    opt_cfg = OptimizerConfig(lr=lr, warmup_steps=20, total_steps=steps,
                              weight_decay=0.01)
    state = adamw_init(params, opt_cfg)
    step_fn = make_train_step(model_loss, params, opt_cfg)
    for p in params.values():
        p.requires_grad_(True)
    losses = []
    try:
        for i in range(steps):
            state, m = step_fn(state, batches(i))
            losses.append(float(m["loss"]))
            if log_every and (i + 1) % log_every == 0:
                print(f"  [{label}] step {i+1}/{steps} "
                      f"loss={np.mean(losses[-log_every:]):.4f}")
    finally:
        for p in params.values():
            p.requires_grad_(False)
    return params, losses


def _make_mllm_batches(seed: int, batch: int = 16, device: DeviceLike = None
                       ) -> Callable[[int], Batch]:
    """Mixed tollbooth/volleyball batches under mixed preprocessing.

    Booth-shot batches (every frame readable) carry the OCR signal; natural
    batches calibrate presence/empty statistics; mixed crops/downscales keep
    the operator accurate under any plan the optimizer produces.
    """
    dev = resolve_device(device)
    tb = TollBoothStream(seed=seed, car_rate=0.03)
    vb = VolleyballStream(seed=seed)

    def gen(i: int) -> Batch:
        mode = i % 6
        if mode in (0, 1, 3):          # booth shots (plate/color/brand)
            frames, labels = tb.booth_batch(batch)
            enc = encode_tollbooth_labels(labels)
            crop, factor = (CROP, 1) if mode != 1 else (CROP, 2)
            x = preprocess_np(frames, crop, factor)
        elif mode == 2:                # natural full frame (naive plan)
            frames, labels = tb.batch(batch)
            enc = encode_tollbooth_labels(labels)
            x = preprocess_np(frames, None, 1)
        elif mode == 4:                # natural cropped
            frames, labels = tb.batch(batch)
            enc = encode_tollbooth_labels(labels)
            x = preprocess_np(frames, CROP, 1)
        else:                          # volleyball
            frames, labels = vb.batch(batch)
            enc = encode_volleyball_labels(labels)
            x = preprocess_np(frames, None, 2)
        return _to_device({"frames": x, **enc}, dev)

    return gen


def _make_distill_batches(seed: int, teacher: StreamMLLM,
                          device: DeviceLike = None
                          ) -> Callable[[int], Batch]:
    """The small model's batches: booth and natural TollBooth frames on
    the optimized preprocessing (crop, /2) and volleyball frames /2, with
    the teacher's logits under ``inference_mode`` (``batch["teacher"]``)."""
    dev = resolve_device(device)
    tb = TollBoothStream(seed=seed + 7, car_rate=0.04)
    vb = VolleyballStream(seed=seed + 7)

    def gen(i: int) -> Batch:
        if i % 3 < 2:
            frames, labels = tb.booth_batch(16) if i % 3 == 0 \
                else tb.batch(16)
            x = preprocess_np(frames, CROP, 2)      # the optimized preproc
            enc = encode_tollbooth_labels(labels)
        else:
            frames, labels = vb.batch(16)
            x = preprocess_np(frames, None, 2)
            enc = encode_volleyball_labels(labels)
        b = _to_device({"frames": x, **enc}, dev)
        with torch.inference_mode():
            t_out = teacher(b["frames"])
        # cloned outside inference mode: the loss saves them for backward
        b["teacher"] = {k: v.clone() for k, v in t_out.items()}
        return b

    return gen


def distill_loss(small: StreamMLLM, b: Batch,
                 temperature: float = 2.0) -> torch.Tensor:
    """Soft-label multi-head distillation from ``b["teacher"]`` plus half
    the small model's supervised loss, both on one forward of the small
    model (the reference runs it twice, which XLA may merge under jit)."""
    s_out = small(b["frames"])
    t = temperature
    total = torch.zeros((), device=small.device)
    for name in s_out:
        p_t = torch.softmax(b["teacher"][name] / t, dim=-1)
        logp = torch.log_softmax(s_out[name] / t, dim=-1)
        total = total + -torch.mean(torch.sum(p_t * logp, dim=-1)) * t * t
    return total + 0.5 * small.loss({k: v for k, v in b.items()
                                     if k != "teacher"}, out=s_out)


def _make_det_batches(seed: int, device: DeviceLike = None
                      ) -> Callable[[int], Batch]:
    dev = resolve_device(device)
    tb2 = TollBoothStream(seed=seed + 13, car_rate=0.02)

    def gen(i: int) -> Batch:
        frames, labels = tb2.batch(16)
        x = preprocess_np(frames, CROP, 2)
        present = np.asarray([int(l["car_present"]) for l in labels],
                             np.int32)
        return _to_device({"frames": x, "present": present}, dev)

    return gen


def quick_stream_models(verbose: bool = False,
                        device: DeviceLike = None) -> OpContext:
    """Tiny, un-cached stream models for smoke runs: enough to exercise
    every code path in seconds (accuracy is the full training's job)."""
    return train_stream_models(steps_mllm=40, steps_small=20, steps_det=30,
                               cache_dir=None, verbose=verbose,
                               device=device)


def stream_models(quick: bool = False, device: DeviceLike = None
                  ) -> OpContext:
    """The examples' single entry point: cached full-quality stream
    models, or the tiny un-cached quick set under ``quick``."""
    if quick:
        print("quick mode: training tiny stream models…")
        return quick_stream_models(verbose=False, device=device)
    print("loading/training stream operator models (cached after "
          "first run)…")
    return train_stream_models(verbose=True, device=device)


def _load(model, tree) -> None:
    """A nested parameter tree of the port's own layout into ``model``."""
    model.load_state_dict(flatten(tree))


def _restore(ck: CheckpointManager, dev, big_cfg, small_cfg) -> OpContext:
    step = ck.latest_step()
    wrote = ck.manifest(step).get("package")
    if wrote != PACKAGE:
        raise ValueError(
            f"{ck.dir}: the stream-model cache was written by "
            f"{wrote or 'another package (no package in its manifest)'}, "
            f"not {PACKAGE}: its conv kernels may be in another layout; "
            "the port reads only its own cache")
    tree = ck.restore(step)
    mllm = StreamMLLM(big_cfg, patch=PATCH, device=dev)
    small = StreamMLLM(small_cfg, patch=PATCH, device=dev)
    det = TinyDet(device=dev)
    d_ff = tree["pruned"]["backbone"]["stack"]["i0"]["mlp"]["w_in"].shape[-1]
    pruned = StreamMLLM(big_cfg.replace(d_ff=int(d_ff)), patch=PATCH,
                        device=dev)
    for model, key in ((mllm, "mllm"), (small, "small"), (pruned, "pruned"),
                       (det, "det")):
        _load(model, tree[key])
    return OpContext(mllm=mllm, mllm_small=small, mllm_pruned=pruned,
                     detector=det, device=dev)


def train_stream_models(steps_mllm: int = 1600, steps_small: int = 500,
                        steps_det: int = 250, seed: int = 0,
                        cache_dir: Optional[str] = CACHE_DIR,
                        force: bool = False, verbose: bool = True,
                        device: DeviceLike = None,
                        stats: Optional[Dict[str, dict]] = None
                        ) -> OpContext:
    """Train (or load cached) streaming models; returns a ready OpContext
    on ``device``.  ``stats``, when given, receives under "mllm",
    "distill" and "tinydet" each run's per-step ``losses`` and its
    ``seconds`` (host clock; each step ends reading its loss)."""
    dev = resolve_device(device)
    big_cfg = get_config("samsara-stream-mllm")
    small_cfg = get_config("samsara-stream-mllm-small")

    ck = CheckpointManager(cache_dir, keep=1, device=dev) \
        if cache_dir else None
    if ck is not None and not force and ck.latest_step() is not None:
        ctx = _restore(ck, dev, big_cfg, small_cfg)
        if verbose:
            print("[pretrain] loaded cached stream models")
        return ctx

    log = 50 if verbose else 0
    stats = {} if stats is None else stats

    def run(label, loss, model, batches, steps, lr):
        t0 = time.perf_counter()
        _, losses = _train(loss, dict(model.named_parameters()), batches,
                           steps, lr=lr, log_every=log, label=label)
        stats[label] = {"losses": losses,
                        "seconds": time.perf_counter() - t0}

    # ---- big MLLM ----
    mllm = StreamMLLM(big_cfg, patch=PATCH, device=dev).init(
        torch.Generator().manual_seed(seed))
    run("mllm", mllm.loss, mllm, _make_mllm_batches(seed, device=dev),
        steps_mllm, 1e-3)

    # ---- distilled small MLLM (physical optimization) ----
    small = StreamMLLM(small_cfg, patch=PATCH, device=dev).init(
        torch.Generator().manual_seed(seed + 1))
    run("distill", lambda b: distill_loss(small, b), small,
        _make_distill_batches(seed, mllm, device=dev), steps_small, 1e-3)

    # ---- structured pruning of the big model (adaptive pruning, static half)
    pruned = structured_prune(mllm, rate=0.5)

    # ---- TinyDet ----
    det = TinyDet(device=dev).init(torch.Generator().manual_seed(seed + 2))
    run("tinydet", det.loss, det, _make_det_batches(seed, device=dev),
        steps_det, 2e-3)

    if ck is not None:
        ck.save(1, {name: nest(dict(model.named_parameters()))
                    for name, model in (("mllm", mllm), ("small", small),
                                        ("pruned", pruned), ("det", det))})
    return OpContext(mllm=mllm, mllm_small=small, mllm_pruned=pruned,
                     detector=det, device=dev)
