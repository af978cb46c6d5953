"""Stacking operators: OpStack (the n->1 barrier) and OpStackBatches (the
larger-than-memory randomized batching engine), mirror of
nightlight_tpu/pipeline/ops_stack.py (reference:
internal/ops/stack/stack.go, stackbatches.go)."""

from __future__ import annotations

import random
from dataclasses import dataclass

import numpy as np
import torch

from nightlight_tpu_torch.image import Image
from nightlight_tpu_torch.ops import stack as stk
from nightlight_tpu_torch.pipeline.context import Context
from nightlight_tpu_torch.pipeline.operators import (
    OpSequence, Operator, materialize_all, register)


@dataclass
class FusedPreprocessSpec:
    """Parameters of the fused whole-batch preprocess
    (models/fastpath.run_fused_preprocess), attached to OpStackBatches by
    the CLI preset: it replaces per_batch.steps[0], the preprocess
    sequence. Wiring only, never part of the JSON job."""

    dark: str = ""
    flat: str = ""
    bp_sigma_low: float = 3.0
    bp_sigma_high: float = 5.0
    star_radius: int = 16
    star_sig: float = 15.0
    star_bp_sig: float = 5.0
    star_in_out: float = 1.4
    export_stats: str | None = None
    debayer: str = ""
    cfa: str = "RGGB"
    pre_scale: float = 1.0
    pre_offset: float = 0.0
    binning: int = 1
    deband_h: tuple | None = None
    deband_v: tuple | None = None
    back_grid: int = 0
    back_sigma: float = 1.5
    back_clip: int = 0
    back_hfr_factor: float = 4.0


@register
class OpStack(Operator):
    """Stack all input frames into one image (stack.go:66-227)."""

    TYPE = "stack"
    PARAMS = {
        "mode": ("mode", int(stk.StackMode.Auto)),
        "weighting": ("weighting", int(stk.StackWeighting.NoWeight)),
        "sigma_low": ("sigmaLow", 2.75),
        "sigma_high": ("sigmaHigh", 2.75),
        "clip_perc_low": ("clipPercLow", 0.5),
        "clip_perc_high": ("clipPercHigh", 0.5),
    }

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.ref_frame_loc = 0.0  # json:"-" in the reference

    def make_promises(self, ins, c):
        if not ins:
            raise ValueError(f"{self.TYPE} operator needs inputs")

        def out():
            fs, err = materialize_all(ins)
            if err is not None:
                raise err
            from nightlight_tpu_torch.pipeline.ops_post import check_align_drop

            fs = [check_align_drop(f, c, project=False) for f in fs]
            fs = [f for f in fs if f is not None]
            if not fs:
                raise ValueError("No frames left to stack after alignment")
            return self.apply(fs, c)

        return [out]

    @staticmethod
    def _batch_frames(fs: list, c: Context) -> torch.Tensor:
        """(N, H, W) batch of the frames with pending warps applied: the
        shift-blend warp over the whole batch when every pending transform
        allows it and shapes are uniform, else per-frame projection."""
        from nightlight_tpu_torch.align import transform as tf
        from nightlight_tpu_torch.ops.resample import (
            plan_batch_shift_warp, project, warp_shift_batch)

        pending = [f for f in fs if f.pending_warp_oob is not None]
        shape0 = fs[0].data.shape
        fused = None
        if pending and all(f.data.dim() == 2 and f.data.shape == shape0
                           and list(f.naxisn) == [shape0[1], shape0[0]] for f in fs):
            invs = [tf.invert(np.asarray(f.trans, np.float32)) if f.pending_warp_oob is not None
                    else tf.invert(tf.identity()) for f in fs]
            fused = plan_batch_shift_warp([f.data.shape for f in fs], fs[0].naxisn, invs)
        if fused is not None:
            kmins, mmins, n_k, n_m = fused
            flags = [f.pending_warp_oob is not None for f in fs]
            oobs = [float(f.pending_warp_oob or 0.0) for f in fs]
            batch = torch.stack([f.data for f in fs])
            for f in fs:
                f.data = None
                f.pending_warp_oob = None
            return warp_shift_batch(batch, invs, oobs, kmins, mmins, flags, n_k, n_m)
        for f in fs:
            if f.pending_warp_oob is None:
                continue
            f.trans = np.asarray(f.trans, np.float32)
            f.set_data(project(f.data, f.naxisn, f.trans, float(f.pending_warp_oob)))
            f.pending_warp_oob = None
        frames = torch.stack([f.data for f in fs])
        for f in fs:
            f.data = None
        return frames

    def apply(self, fs: list, c: Context) -> Image:
        mode = stk.StackMode(self.mode)
        if mode == stk.StackMode.Auto:
            mode = stk.auto_select_mode(len(fs))
        c.logf("Stacking %d frames with stacking mode %d and sigma low %g high %g:\n",
               len(fs), int(mode), self.sigma_low, self.sigma_high)
        weights = stk.get_weights(fs, stk.StackWeighting(self.weighting), device=c.device)
        exposure_sum = sum(f.exposure for f in fs)
        naxisn0 = list(fs[0].naxisn)
        ls_mode0 = fs[0].stats.mode if fs[0].stats else None
        frames = self._batch_frames(fs, c)
        for f in fs:
            if f.stats is not None:
                f.stats.free_data()
        if self.sigma_low < 0 or self.sigma_high < 0:
            from nightlight_tpu_torch.ops.findsigma import find_sigmas_and_stack

            data, clip_lo, clip_hi, _, _ = find_sigmas_and_stack(
                frames, mode, weights=weights, ref_frame_loc=self.ref_frame_loc,
                clip_perc_low=self.clip_perc_low, clip_perc_high=self.clip_perc_high,
                log=c.log)
        else:
            data, clip_lo, clip_hi = stk.stack(frames, mode, weights=weights,
                                               sigma_low=self.sigma_low,
                                               sigma_high=self.sigma_high,
                                               ref_frame_loc=self.ref_frame_loc)
        del frames
        if mode >= stk.StackMode.Sigma:
            total = len(fs) * fs[0].pixels
            clip_lo, clip_hi = int(clip_lo), int(clip_hi)
            c.logf("Clipped low %d (%.2f%%) high %d (%.2f%%)\n",
                   clip_lo, clip_lo * 100.0 / total, clip_hi, clip_hi * 100.0 / total)
        result = Image.from_naxisn(naxisn0, data, ls_mode=ls_mode0)
        result.exposure = exposure_sum
        return result


@register
class OpStackBatches(Operator):
    """Larger-than-memory stacking: solve a memory-feasible batch size,
    permute the frames randomly into batches, run the per-batch sub-DAG and
    combine incrementally (stackbatches.go:30-210)."""

    TYPE = "stackBatches"
    PARAMS = {}

    def __init__(self, per_batch: OpSequence | None = None,
                 fused_spec: FusedPreprocessSpec | None = None,
                 fused_reason: str | None = None, **kwargs):
        super().__init__(**kwargs)
        self.per_batch = per_batch or OpSequence()
        self.fused_spec = fused_spec
        self.fused_reason = fused_reason

    def to_dict(self) -> dict:
        return {"type": self.TYPE, "perBatch": self.per_batch.to_dict()}

    @classmethod
    def from_dict(cls, d: dict) -> "OpStackBatches":
        from nightlight_tpu_torch.pipeline.operators import op_from_dict

        pb = d.get("perBatch")
        return cls(per_batch=op_from_dict(pb) if pb else None)

    def make_promises(self, ins, c):
        if not ins:
            raise ValueError("No frames to batch process")
        return [lambda: self.apply(ins, c)]

    def apply(self, ins, c: Context) -> Image:
        ins_perm, num_batches, batch_size, max_threads = self._partition(ins, c)
        c.max_threads = max_threads
        c.stats_total = len(ins_perm)
        c.stats_processed = 0

        stack_acc = None
        stack_img = None
        stack_frames = 0
        for b in range(num_batches):
            batch = ins_perm[b * batch_size:(b + 1) * batch_size]
            c.logf("\nStarting batch %d of %d with %d frames...\n", b + 1, num_batches, len(batch))
            promises = self._batch_promises(batch, c)
            if len(promises) != 1:
                raise ValueError("stacking returned more than one promise")
            batch_img = promises[0]()
            if num_batches > 1:
                if stack_img is None:
                    stack_img = Image.like(batch_img)
                    stack_img.exposure = 0.0
                stack_acc = stk.stack_incremental(stack_acc, batch_img.data, float(len(batch)))
                stack_img.exposure += batch_img.exposure
                stack_frames += len(batch)
            else:
                stack_img = batch_img
        c.dark_frame, c.flat_frame = None, None
        if num_batches > 1:
            stack_img.set_data(stk.stack_incremental_finalize(stack_acc, float(stack_frames)))
        return stack_img

    def _batch_promises(self, batch, c: Context):
        """The fused whole-batch preprocess followed by the rest of the
        per-batch chain. The per-frame operator path is not ported: a batch
        the fused executor cannot take raises with the reason."""
        from nightlight_tpu_torch.models.fastpath import fused_batch_eligible, run_fused_preprocess

        if self.fused_spec is None or not self.per_batch.steps:
            reason = self.fused_reason or "no fused preprocess for this chain"
            raise NotImplementedError(f"the per-frame operator path is not ported yet "
                                      f"({reason}); queued in ROADMAP.md")
        images, err = materialize_all(batch)
        if err is not None:
            raise err
        eligible, reason = fused_batch_eligible(images, c)
        if not eligible:
            raise NotImplementedError(f"the per-frame operator path is not ported yet "
                                      f"({reason}); queued in ROADMAP.md")
        run_fused_preprocess(images, c, self.fused_spec)
        tail = OpSequence(steps=list(self.per_batch.steps[1:]))
        return tail.make_promises([lambda img=img: img for img in images], c)

    @staticmethod
    def _device_memory_mb(device: torch.device) -> int:
        """Usable accelerator memory in MiB: the free memory of a CUDA
        device; on the CPU the JAX package's answer (effectively unbounded,
        host memory governs)."""
        if device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(device)
            return int(free // (1 << 20))
        return 1 << 30

    def _partition(self, ins, c: Context):
        """Memory-budget solver + random permutation (stackbatches.go:121-210)."""
        num_frames = len(ins)
        if c.dark_frame is not None:
            width, height = c.dark_frame.naxisn[0], c.dark_frame.naxisn[1]
        elif c.flat_frame is not None:
            width, height = c.flat_frame.naxisn[0], c.flat_frame.naxisn[1]
        else:
            first = ins[0]()
            c.logf("\nEstimating memory needs for %d images from %s:\n", num_frames,
                   first.file_name)
            width, height = first.naxisn[0], first.naxisn[1]
            ins = [(lambda img=first: img)] + list(ins[1:])
        pixels = width * height
        nbytes = pixels * 4
        mib = nbytes // (1 << 20)
        c.logf("%d images of %dx%d pixels (%.1f MPixels), which each take %d MiB in-memory"
               " as floating point.\n", num_frames, width, height, pixels * 1e-6, mib)

        if self.fused_spec is not None:
            # detection's candidate working set per DETECT_CHUNK slice, in
            # the JAX package's (8, 128)-tiled units, plus 2x the frames
            from nightlight_tpu_torch.detect.stars import MAX_CANDIDATES
            from nightlight_tpu_torch.models.fastpath import DETECT_CHUNK

            patch = 4 * (self.fused_spec.star_radius or 16) + 1
            detect_ws_mb = (DETECT_CHUNK * MAX_CANDIDATES
                            * ((patch + 15) // 8 * 8) * ((patch + 127) // 128 * 128)
                            * 4 * 6) >> 20
            dev_budget_mb = self._device_memory_mb(c.device) * 5 // 10
            dev_frames = max(0, dev_budget_mb - detect_ws_mb) // max(1, 2 * mib)
            available_frames = min((c.stack_memory_mb << 20) // nbytes, dev_frames)
        else:
            budget_mb = min(c.stack_memory_mb, self._device_memory_mb(c.device) * 6 // 10)
            available_frames = (budget_mb << 20) // nbytes
        c.logf("CPU has %d threads. Physical memory is %d MiB, -op.Memory is %d MiB,"
               " this fits %d frames.\n", c.max_threads, c.memory_mb, c.stack_memory_mb,
               available_frames)

        def solve(avail):
            max_threads = c.max_threads
            num_batches = batch_size = 0
            while max_threads >= 1:
                batch_size = avail - max_threads
                if c.dark_frame is not None:
                    batch_size -= 1
                if c.flat_frame is not None:
                    batch_size -= 1
                if batch_size < 2:
                    max_threads -= 1
                    continue
                num_batches = (num_frames + batch_size - 1) // batch_size
                if num_batches > 1:
                    batch_size -= 2  # reference frame + stack of stacks
                if batch_size < 2 or batch_size < max_threads:
                    max_threads -= 1
                    continue
                break
            if max_threads < 1 or batch_size < 2:
                raise ValueError("Cannot find a stacking execution path within the given "
                                 "memory constraints.")
            # the batch count comes from the FINAL batch size, so every frame
            # is stacked (the reference's count can drop the last frames,
            # stackbatches.go:168-184); then shrink the batches to fit
            num_batches = (num_frames + batch_size - 1) // batch_size
            while (batch_size - 1) * num_batches >= num_frames:
                batch_size -= 1
            return num_batches, batch_size, max_threads

        num_batches, batch_size, max_threads = solve(available_frames)
        if num_batches > 1 and self.fused_spec is not None:
            # the JAX package re-solves a multi-batch run with a reserve for
            # prefetching the next batch (2.5x instead of 2x the frame size
            # per frame); the same plan keeps the batches identical
            dev_budget_mb = self._device_memory_mb(c.device) * 5 // 10
            dev_frames_r = max(0, dev_budget_mb - detect_ws_mb) // max(1, 2 * mib + (mib + 1) // 2)
            num_batches, batch_size, max_threads = solve(
                min((c.stack_memory_mb << 20) // nbytes, dev_frames_r))
        c.logf("Using %d random batches of size %d with %d images in parallel.\n",
               num_batches, batch_size, max_threads)
        ins_perm = list(ins)
        if num_batches > 1:
            c.logf("Randomizing input files into batches...\n")
            perm = list(range(len(ins)))
            random.shuffle(perm)
            for i in range(num_batches):
                lo, hi = i * batch_size, min((i + 1) * batch_size, len(perm))
                perm[lo:hi] = sorted(perm[lo:hi])
            ins_perm = [ins[p] for p in perm]
        return ins_perm, num_batches, batch_size, max_threads
