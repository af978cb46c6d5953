"""Stacking operators: OpStack (the n->1 barrier) and OpStackBatches (the
larger-than-memory randomized batching engine), mirror of
nightlight_tpu/pipeline/ops_stack.py (reference:
internal/ops/stack/stack.go, stackbatches.go)."""

from __future__ import annotations

import os
import random
from dataclasses import dataclass

import numpy as np
import torch

from nightlight_tpu_torch import trace
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
    def _batch_frames(fs: list, c: Context):
        """(N, H, W) batch of the frames with pending warps applied: the
        shift-blend warp over the whole batch when every pending transform
        allows it and shapes are uniform, else per-frame projection (mixed
        shapes, a mesh). Under c.mesh the frames are row-sharded: each is
        projected shard by shard (ops/resample.py), and each device's
        blocks are stacked into its block of the cube, a RowSharded batch,
        with no gather. The batch shift-blend warp stays off under a mesh,
        as in the JAX package (pipeline/ops_stack.py:115)."""
        from nightlight_tpu_torch.align import transform as tf
        from nightlight_tpu_torch.ops.resample import (
            plan_batch_shift_warp, project, warp_shift_batch)

        pending = [f for f in fs if f.pending_warp_oob is not None]
        shape0 = fs[0].data.shape
        fused = None
        if pending and c.mesh is None and all(f.data.dim() == 2 and f.data.shape == shape0
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
        if c.mesh is not None:
            from nightlight_tpu_torch.parallel import mesh as pm

            datas = [f.data for f in fs]
            for f in fs:
                f.data = None
            if all(isinstance(d, pm.RowSharded) and not d.replicated and d.mesh == c.mesh
                   and d.shape == datas[0].shape for d in datas):
                blocks = [torch.stack([d.blocks[k] for d in datas])
                          for k in range(c.mesh.size)]
                return pm.RowSharded(c.mesh, (len(datas), *datas[0].shape), blocks)
            # replicated frames (rows that do not divide the mesh)
            return pm.place_on_mesh(torch.stack([pm.gather(d, "stack") for d in datas]),
                                    c.mesh)
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
        # c.mesh routes the reduction per shard (stack_sharded, the sharded
        # goal-seek): each shard's kernel on its rows, the counts summed
        if self.sigma_low < 0 or self.sigma_high < 0:
            from nightlight_tpu_torch.ops.findsigma import find_sigmas_and_stack

            data, clip_lo, clip_hi, _, _ = find_sigmas_and_stack(
                frames, mode, weights=weights, ref_frame_loc=self.ref_frame_loc,
                clip_perc_low=self.clip_perc_low, clip_perc_high=self.clip_perc_high,
                log=c.log, mesh=c.mesh)
        else:
            data, clip_lo, clip_hi = stk.stack(frames, mode, weights=weights,
                                               sigma_low=self.sigma_low,
                                               sigma_high=self.sigma_high,
                                               ref_frame_loc=self.ref_frame_loc, mesh=c.mesh)
        # under c.mesh the stacked image stays row-sharded: its statistics,
        # detection and the stretch operators run on the shards, and the
        # writers gather it (OpSave)
        del frames
        if mode >= stk.StackMode.Sigma:
            total = len(fs) * fs[0].pixels
            clip_lo, clip_hi = int(trace.to_host(clip_lo)), int(trace.to_host(clip_hi))
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
        # raw bytes of the next batch read ahead during this batch's
        # compute; set by _partition for a multi-batch fused run
        self._prefetch_bytes = 0

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
            next_batch = ins_perm[(b + 1) * batch_size:(b + 2) * batch_size]
            c.logf("\nStarting batch %d of %d with %d frames...\n", b + 1, num_batches, len(batch))
            promises = self._batch_promises(batch, c, next_batch=next_batch)
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

    @staticmethod
    def _batch_loader(batch):
        """(load order, read-ahead loader) found through a batch's load
        promises (io/ingest.py)."""
        names, loader = [], None
        for p in batch:
            op = getattr(p, "op", None)
            fn = getattr(op, "file_name", None)
            if fn:
                names.append(fn)
                loader = getattr(op, "_prefetcher", None) or loader
        return names, loader

    @classmethod
    def _announce_batch(cls, batch) -> None:
        """Tell the load set's loader this batch's load order, so that its
        readers take this batch's frames first."""
        names, loader = cls._batch_loader(batch)
        if names and loader is not None:
            loader.reorder(names)

    def _prefetch_next(self, next_batch, c: Context) -> None:
        """Read the NEXT batch's frames ahead now, while this batch's
        preprocess, alignment and stack run: its raw payloads wait on the
        card within the reserve _partition budgeted. The reference's batch
        loop is strictly sequential, its constraint being host memory
        (stackbatches.go:56-107). NIGHTLIGHT_NO_PREFETCH=1 turns it off
        (the JAX package's A/B control); the loader still reads each batch
        ahead within its window."""
        if not next_batch or not self._prefetch_bytes \
                or os.environ.get("NIGHTLIGHT_NO_PREFETCH"):
            return
        names, loader = self._batch_loader(next_batch)
        if not names or loader is None:
            return
        n = loader.prefetch_ahead(names, self._prefetch_bytes)
        if n:
            c.logf("Prefetched %d frames of the next batch during this batch's compute.\n", n)

    def _batch_promises(self, batch, c: Context, next_batch=None):
        """Promise chain for one batch: the fused whole-batch preprocess
        followed by the rest of the per-batch chain when the batch is
        eligible, else the per-frame operator chain, with the JAX package's
        line saying why (nightlight_tpu/pipeline/ops_stack.py)."""
        from nightlight_tpu_torch.models.fastpath import fused_batch_eligible, run_fused_preprocess

        self._announce_batch(batch)
        if self.fused_spec is None or not self.per_batch.steps:
            if self.per_batch.steps and self.fused_reason:
                c.logf("Fused batch executor off (%s); using the per-frame "
                       "operator path.\n", self.fused_reason)
            return self.per_batch.make_promises(batch, c)
        images, err = materialize_all(batch)
        if err is not None:
            raise err
        # this batch's frames are loaded; queue the next batch's reads
        # before this batch's compute
        self._prefetch_next(next_batch, c)
        wrapped = [lambda img=img: img for img in images]
        eligible, reason = fused_batch_eligible(images, c)
        if not eligible:
            c.logf("Fused batch executor off (%s); using the per-frame "
                   "operator path.\n", reason)
            return self.per_batch.make_promises(wrapped, c)
        run_fused_preprocess(images, c, self.fused_spec)
        tail = OpSequence(steps=list(self.per_batch.steps[1:]))
        return tail.make_promises(wrapped, c)

    @staticmethod
    def _device_memory_mb(device: torch.device) -> int:
        """Usable accelerator memory in MiB: the free memory of a CUDA
        device plus what PyTorch's allocator holds cached and unused (its
        to reuse, or to release under pressure), so that the plan does not
        depend on what earlier work left in the cache (the read-ahead
        loader's side stream keeps a pool of its own); on the CPU the JAX
        package's answer (effectively unbounded, host memory governs)."""
        if device.type == "cuda":
            free, _total = torch.cuda.mem_get_info(device)
            cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
            return int((free + cached) // (1 << 20))
        return 1 << 30

    @staticmethod
    def _mesh_share(c: Context, device_mb: dict, width: int, height: int, radius: int):
        """What each device of c.mesh holds of a frame, for a plan that
        counts the mesh: ((MiB rounded up, bytes) of one shard's rows, the
        halo the warp takes above and below included, [(usable MiB from
        `device_mb`, shards, MiB besides the frames)] per distinct device).
        Besides the frames the lead holds whole frames at the save (the
        gathered stack and the writers' two working copies) and the sharded
        detector's merged candidate lists and patches. None where the rows
        do not divide the mesh: the frames are then replicated on the lead,
        and the lead alone is counted."""
        from nightlight_tpu_torch.detect.stars import MAX_CANDIDATES
        from nightlight_tpu_torch.parallel import mesh as pm

        mesh = c.mesh
        if not pm.divides(mesh, (height, width)):
            return None
        shard_bytes = (height // mesh.size + 2 * pm.HALO_CAP) * width * 4
        patch = 4 * radius + 1
        lead_mib = (3 * width * height * 4
                    + MAX_CANDIDATES * (12 * mesh.size + 5 * patch * patch)) >> 20
        shards = {}
        for d in mesh.devices:
            shards[d] = shards.get(d, 0) + 1
        return (-(-shard_bytes // (1 << 20)), shard_bytes), [
            (device_mb[d], n, lead_mib if d == mesh.lead else 0) for d, n in shards.items()]

    def _partition(self, ins, c: Context):
        """Memory-budget solver + random permutation (stackbatches.go:121-210).

        Under c.mesh (-shard) each device holds its shard's rows of every
        frame, so the device budget counts each device's memory against
        its shards' rows (_mesh_share), the smallest count of frames over
        the devices binding; without a mesh, or with frames replicated on
        the lead, the context's device alone is counted, as in the JAX
        package."""
        num_frames = len(ins)
        # measured before any frame is loaded: the read-ahead loader starts
        # reading at the first frame taken, and its frames on the device
        # must not move the plan
        device_mb = self._device_memory_mb(c.device)
        mesh_mb = (None if c.mesh is None
                   else {d: self._device_memory_mb(d) for d in c.mesh.devices})
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

        radius = (self.fused_spec.star_radius if self.fused_spec is not None else 0) or 16
        share = (None if mesh_mb is None
                 else self._mesh_share(c, mesh_mb, width, height, radius))

        # a frame's (MiB, bytes) on each device, and the devices as
        # [(usable MiB, shards, MiB besides the frames)]: the whole frame
        # on the context's device, or under a mesh its shard (_mesh_share)
        frame, devices = ((mib, nbytes), [(device_mb, 1, 0)]) if share is None else share

        def device_frames(tenths: int, reserve_mb: int, per_frame) -> int:
            """Frames that `tenths` of a device's memory, less reserve_mb
            and what it holds besides, takes at per_frame(MiB, bytes of a
            frame) bytes a frame: the least over the devices."""
            return min((max(0, mb * tenths // 10 - reserve_mb - extra) << 20)
                       // (shards * per_frame(*frame)) for mb, shards, extra in devices)

        host_frames = (c.stack_memory_mb << 20) // nbytes
        # Under -shard the stack takes the per-frame path (models/fastpath.py)
        # but keeps its fused spec, so the mesh is budgeted with the fused
        # executor's constants (detection's working set, 2x and 2.5x the
        # frames): a margin, not a model of the sharded per-frame path.
        if self.fused_spec is not None:
            # detection's candidate working set per DETECT_CHUNK slice, in
            # the JAX package's (8, 128)-tiled units, plus 2x the frames
            from nightlight_tpu_torch.detect.stars import MAX_CANDIDATES
            from nightlight_tpu_torch.models.fastpath import DETECT_CHUNK

            patch = 4 * radius + 1
            detect_ws_mb = (DETECT_CHUNK * MAX_CANDIDATES
                            * ((patch + 15) // 8 * 8) * ((patch + 127) // 128 * 128)
                            * 4 * 6) >> 20
            available_frames = min(host_frames, device_frames(
                5, detect_ws_mb, lambda m, b: max(1, 2 * m) << 20))
        else:
            available_frames = min(host_frames, device_frames(6, 0, lambda m, b: b))
        counted = "" if share is None else (
            " on the mesh's %d devices (%d MiB a frame's shard, the least device %d MiB)"
            % (c.mesh.size, frame[0], min(mb for mb, _, _ in devices)))
        c.logf("CPU has %d threads. Physical memory is %d MiB, -op.Memory is %d MiB,"
               " this fits %d frames%s.\n", c.max_threads, c.memory_mb, c.stack_memory_mb,
               available_frames, counted)

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
        self._prefetch_bytes = 0
        if num_batches > 1 and self.fused_spec is not None:
            # a reserve for the next batch's raw frames (half a float32
            # frame each), read ahead while this batch holds its float32
            # frames through the warp: 2.5x instead of 2x the frame size
            # per frame. Re-solve with it, as the JAX package does.
            num_batches, batch_size, max_threads = solve(min(host_frames, device_frames(
                5, detect_ws_mb, lambda m, b: max(1, 2 * m + (m + 1) // 2) << 20)))
            self._prefetch_bytes = batch_size * (nbytes // 2)
        trace.count("stack.batches", "device" if share is None else "mesh", num_batches)
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
