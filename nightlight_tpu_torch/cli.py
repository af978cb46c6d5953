"""Command-line interface of the port, mirror of nightlight_tpu/cli.py
(reference: cmd/nightlight/main.go): the same flags, per-command defaults,
%auto filename derivation, job-JSON echo and log lines. The ``stack``
command runs; the other processing commands are queued in ROADMAP.md.

On a machine with a GPU the pipeline runs on cuda:0, with TF32 disabled for
matrix products and cuDNN so float32 math stays float32.

    python -m nightlight_tpu_torch.cli -out stacked.fits -dark dark.fits stack 'lights/*.fits'
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from nightlight_tpu_torch import __version__
from nightlight_tpu_torch.models.presets import build_command_seq
from nightlight_tpu_torch.ops.stats import LSEstimatorMode
from nightlight_tpu_torch.utils.logging import MultiWriter, auto_fill

# The command set of the JAX CLI, in the order of the usage synopsis.
COMMANDS = {
    "stats": "load frames, detect stars, and print per-frame statistics (no output image)",
    "stack": "calibrate, detect, align, and stack light frames into one master",
    "stretch": "post-process a single (stacked) frame: stretch, curves, sharpening, save",
    "rgb": "combine 3 (RGB) or 4 (LRGB) channel masters, balance, HSL chain, stretch, save",
    "lrgb": "alias of rgb with a luminance channel first (the reference lists it in "
            "usage but never dispatches it, main.go:301-414; here it runs)",
    "run": "execute a JSON job file (-job job.json) through the operator DAG",
    "serve": "start the REST API + web job editor on -port",
    "legal": "print license information",
    "version": "print the version",
}
_USAGE_CMDS = "|".join(COMMANDS)


def build_parser() -> argparse.ArgumentParser:
    """All flags of main.go:49-166 with identical names and defaults."""
    p = argparse.ArgumentParser(
        prog="nightlight-tpu-torch",
        description="astrophotography pipeline in PyTorch (JSON job DSL compatible with nightlight)",
        usage=f"%(prog)s [-flag value] ({_USAGE_CMDS}) (img0.fits ... imgn.fits)",
    )
    a = p.add_argument
    a("command", nargs="?", default="")
    a("files", nargs="*", default=[])

    a("-port", type=int, default=8080, help="port for serving HTTP API")
    a("-chroot", default="", help="directory to chroot and chdir to when serving HTTP. must be run as root")
    a("-setuid", type=int, default=-1, help="user id number to setuid to when serving HTTP. must be run as root")
    a("-job", default="", help="JSON job specification to run")
    a("-trace", default="", help="write a torch.profiler trace of the run to this directory"
      " (the analog of the reference's -cpuprofile/-memprofile)")
    a("-shard", action="store_true",
      help="row-shard frames across all attached devices (not ported yet)")

    a("-out", default="out.fits", help="save output to file")
    a("-jpg", default="%auto", help="save 8bit preview of output as JPEG")
    a("-jpgGamma", type=float, default=1.0, help="gamma correction for JPG output")
    a("-tiff", default="", help="save 16bit preview of output as TIFF")
    a("-log", default="%auto", help="save log output to file")
    a("-pre", dest="pre", default="", help="save pre-processed frames with filename pattern")
    a("-stars", default="", help="save star detections with filename pattern")
    a("-back", default="", help="save extracted background with filename pattern")
    a("-post", dest="post", default="", help="save post-processed frames with filename pattern")
    a("-batch", default="", help="save stacked batches with filename pattern")

    a("-dark", default="", help="apply dark frame from file")
    a("-flat", default="", help="apply flat frame from file")

    a("-debayer", default="", help="debayer the given channel, one of R, G, B")
    a("-cfa", default="RGGB", help="color filter array for debayering")

    a("-debandH", type=float, default=0.0,
      help="horizontal debanding percentile in [0..100]; 0 disables")
    a("-debandV", type=float, default=0.0,
      help="vertical debanding percentile in [0..100]; 0 disables")
    a("-debandHWindow", type=int, default=128,
      help="rolling window height (rows) for horizontal debanding")
    a("-debandVWindow", type=int, default=128,
      help="rolling window width (columns) for vertical debanding")
    a("-debandHSigma", type=float, default=3.0,
      help="ignore pixels above location + this*scale when estimating row banding; 0 disables")
    a("-debandVSigma", type=float, default=3.0,
      help="ignore pixels above location + this*scale when estimating column banding; 0 disables")

    a("-binning", type=int, default=0,
      help="sum NxN pixel blocks into one; 0 or 1 = no binning")

    a("-bpSigLow", type=float, default=3.0,
      help="bad-pixel rejection: flag pixels below location - this*scale")
    a("-bpSigHigh", type=float, default=5.0,
      help="bad-pixel rejection: flag pixels above location + this*scale")

    a("-starSig", type=float, default=15.0,
      help="star detection threshold in scales above location")
    a("-starBpSig", type=float, default=-1.0,
      help="bad-pixel sigma used inside star detection; -1 picks a per-command default")
    a("-starInOut", type=float, default=1.4,
      help="minimum brightness ratio inside vs outside the HFR for a star candidate")
    a("-starRadius", type=int, default=16,
      help="candidate window radius in pixels for star detection")

    a("-backGrid", type=int, default=0,
      help="automated background extraction cell size in pixels; 0 disables")
    a("-backHFRFactor", type=float, default=4.0,
      help="background extraction: mask stars out to HFR times this factor")
    a("-backSigma", type=float, default=1.5,
      help="background extraction: sigma threshold for excluding foreground objects")
    a("-backClip", type=int, default=0,
      help="background extraction: replace the k brightest cells with their local median")

    a("-minStars", type=int, default=0,
      help="drop frames with fewer detected stars than this before stacking; 0 = keep all")

    a("-blurSigma", type=float, default=0.0,
      help="gaussian blur sigma (~1/3 of the radius); 0 = no blur")
    a("-usmSigma", type=float, default=1.0,
      help="unsharp-mask gaussian sigma (~1/3 of the radius)")
    a("-usmGain", type=float, default=0.0,
      help="unsharp-mask gain; 0 = no sharpening")
    a("-usmThresh", type=float, default=1.0,
      help="unsharp-mask threshold in scales above background location")

    a("-alignK", type=int, default=20,
      help="number of brightest stars whose triangles seed alignment")
    a("-alignT", type=float, default=1.0,
      help="drop frames whose alignment residual to the reference exceeds this")

    a("-lsEst", type=int, default=3,
      help="location/scale estimator: 0=mean/stddev, 1=median/MAD, 2=IKSS,"
           " 3=iterative sigma-clipped sampled median + sampled Qn, 4=histogram peak")
    a("-normRange", type=int, default=0,
      help="1 = normalize pixel range to [0,1] after loading; 0 = keep raw values")
    a("-normHist", type=int, default=4,
      help="histogram normalization: 0=off, 1=location, 2=location+scale,"
           " 3=black-point shift for RGB alignment, 4=per-command auto")

    a("-stMode", type=int, default=6,
      help="stacking mode: 0=median, 1=mean, 2=sigma clip, 3=winsorized sigma clip,"
           " 4=MAD sigma clip, 5=linear fit, 6=auto by frame count")
    a("-stSigLow", type=float, default=-1.0,
      help="low clipping sigma for stacking; -1 = goal-seek from the target clip percentage")
    a("-stSigHigh", type=float, default=-1.0,
      help="high clipping sigma for stacking; -1 = goal-seek from the target clip percentage")
    a("-stWeight", type=int, default=0,
      help="stacking weights: 0=unweighted, 1=by exposure, 2=by inverse noise")
    a("-stMemory", type=int, default=0,
      help="memory budget in MiB for stacking; splits the job into randomized"
           " out-of-core batches when the frame set exceeds it (0 = size to the device)")

    a("-histoRef", default="%starsHFR",
      help="histogram-match reference: %%starsHFR=best stars/HFR score,"
           " %%location=median location, an integer image ID, or a filename")
    a("-alignRef", default="%starsHFR",
      help="alignment reference: %%starsHFR=best stars/HFR score,"
           " %%location=median location, an integer image ID, or a filename")

    a("-neutSigmaLow", type=float, default=-1.0,
      help="neutralize background color below this sigma threshold; <0 disables")
    a("-neutSigmaHigh", type=float, default=-1.0,
      help="keep background color above this sigma threshold, interpolating between; <0 disables")

    a("-balBlock", type=int, default=16,
      help="auto balance: edge length of the darkest block balanced to black")
    a("-balBorder", type=float, default=0.1,
      help="auto balance: fraction of the image border excluded from the block search")
    a("-balSkipBright", type=float, default=0.0,
      help="auto balance: skip this brightest fraction of stars when balancing star colors")
    a("-balSkipDim", type=float, default=0.5,
      help="auto balance: skip this dimmest fraction of stars when balancing star colors")
    a("-balShR", type=float, default=1.0, help="tint shadows with this red component [0..1]")
    a("-balShG", type=float, default=1.0, help="tint shadows with this green component [0..1]")
    a("-balShB", type=float, default=1.0, help="tint shadows with this blue component [0..1]")
    a("-balHiR", type=float, default=1.0, help="tint highlights with this red component [0..1]")
    a("-balHiG", type=float, default=1.0, help="tint highlights with this green component [0..1]")
    a("-balHiB", type=float, default=1.0, help="tint highlights with this blue component [0..1]")

    a("-chromaGamma", type=float, default=1.0,
      help="gamma applied to the LCH chroma curve for luminances above the"
           " -chromaSigma threshold; 1 = no op")
    a("-chromaSigma", type=float, default=1.0,
      help="apply chroma adjustments only to luminances this many scales above background")
    a("-chromaFrom", type=float, default=295.0,
      help="start hue angle (degrees) of the selective chroma adjustment range")
    a("-chromaTo", type=float, default=40.0,
      help="end hue angle (degrees) of the selective chroma adjustment range")
    a("-chromaBy", type=float, default=1.0,
      help="chroma scale factor for hues inside [chromaFrom, chromaTo]; 1 = no op")

    a("-rotFrom", type=float, default=100.0,
      help="start hue angle (degrees) of the selective hue rotation range")
    a("-rotTo", type=float, default=190.0,
      help="end hue angle (degrees) of the selective hue rotation range")
    a("-rotBy", type=float, default=0.0,
      help="hue rotation offset (degrees) for hues inside [rotFrom, rotTo];"
           " 0 = no op (e.g. -30 maps greens toward gold for SHO palettes)")
    a("-rotSigma", type=float, default=1.0,
      help="rotate hues only for luminances this many scales above background location")

    a("-scnr", type=float, default=0.0,
      help="subtractive chromatic noise reduction on green in [0,1]; 0 = off")

    a("-autoLoc", type=float, default=10.0,
      help="auto-stretch target for the histogram peak location, in %%; 0 disables")
    a("-autoScale", type=float, default=0.4,
      help="auto-stretch target for the histogram peak scale, in %%; 0 disables")

    a("-midtone", type=float, default=0.0,
      help="midtone transfer strength in scales above background; 0 = no op")
    a("-midBlack", type=float, default=2.0,
      help="midtone black point, in scales below the background location")

    a("-gamma", type=float, default=1.0, help="output gamma; 1 keeps linear data")
    a("-ppGamma", type=float, default=1.0,
      help="post-peak gamma applied above location + ppSigma*scale; 1 = no op")
    a("-ppSigma", type=float, default=1.0,
      help="post-peak gamma starts this many scales above the histogram peak")

    a("-preScale", type=float, default=1.0, help="multiply pixels by this factor on load")
    a("-preOffset", type=float, default=0.0, help="add this offset to pixels on load")

    a("-lumScale", type=float, default=1.0, help="multiply the luminance channel by this factor")
    a("-lumOffset", type=float, default=0.0, help="add this offset to the luminance channel")

    a("-scaleBlack", type=float, default=0.0,
      help="shift the black point so the histogram peak lands at this value in %%; 0 = off")

    a("-exportStats", default="%auto",
      help="write the per-frame statistics report (SVG charts) to this file;"
           " %%auto derives it from -out")
    a("-allowAbsolutePaths", action="store_true",
      help="disable the relative-path sandbox for local CLI runs")
    return p


HNM_AUTO = 4
HNM_NONE = 0
HNM_LOC_SCALE = 2


def apply_command_defaults(args) -> None:
    """Per-command defaults resolution (main.go:236-273)."""
    cmd = args.command
    if cmd == "stats":
        args.bpSigLow = 0.0
        args.bpSigHigh = 0.0
        if args.normHist == HNM_AUTO:
            args.normHist = HNM_NONE
        if args.starBpSig < 0:
            args.starBpSig = 0.0
    elif cmd == "stack":
        if args.normHist == HNM_AUTO:
            args.normHist = HNM_LOC_SCALE
        if args.starBpSig < 0:
            args.starBpSig = 5.0
    elif cmd in ("rgb", "lrgb"):
        if args.normHist == HNM_AUTO:
            args.normHist = HNM_NONE
        if args.starBpSig < 0:
            args.starBpSig = 0.0


def run_op(op, c) -> None:
    """Echo the job JSON and run its promises (main.go:458-473)."""
    from nightlight_tpu_torch.pipeline.operators import materialize_all

    c.logf("\nRunning JSON job:\n%s\n", op.to_json())
    promises = op.make_promises([], c)
    _, err = materialize_all(promises, forget=True)
    c.finalize()
    if err is not None:
        raise err


LEGAL = """nightlight_tpu_torch, an astrophotography processing framework in PyTorch.
This program comes with ABSOLUTELY NO WARRANTY.
Capability set modeled on mlnoga/nightlight (GPL-3.0); this implementation
is an independent rebuild.
"""


def main(argv=None, device=None) -> int:
    """Run the CLI; `device` overrides the default (cuda:0 when present)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parser = build_parser()
    args = parser.parse_args(argv)
    start = time.time()

    log_writer = sys.stdout
    args.log = auto_fill(args.log, args.out, ".log")
    log_file = None
    if args.log:
        log_file = open(args.log, "w")
        log_writer = MultiWriter(sys.stdout, log_file)
    if os.environ.get("NIGHTLIGHT_LOG_TIMES"):
        from nightlight_tpu_torch.utils.logging import TimestampWriter

        log_writer = TimestampWriter(log_writer)

    args.jpg = auto_fill(args.jpg, args.out, ".jpg")
    args.tiff = auto_fill(args.tiff, args.out, ".tif")
    args.exportStats = auto_fill(args.exportStats, args.out, ".html")

    cmd = args.command
    if not cmd:
        parser.print_usage()
        return 0
    if cmd in ("stats", "stack", "stretch", "rgb", "lrgb"):
        log_writer.write(f"Using location and scale estimator {args.lsEst}\n")

    apply_command_defaults(args)

    from nightlight_tpu_torch.pipeline import operators as opmod
    from nightlight_tpu_torch.pipeline.context import new_context

    if args.allowAbsolutePaths:
        opmod.ALLOW_ABSOLUTE_PATHS = True

    profiler = None
    try:
        c = new_context(log=log_writer, st_memory=args.stMemory,
                        ls_mode=LSEstimatorMode(args.lsEst), device=device)
        if args.shard:
            raise NotImplementedError("-shard is not ported yet (queued in ROADMAP.md)")
        if args.trace:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if c.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.__enter__()
        if cmd in ("stats", "stack", "stretch", "rgb", "lrgb"):
            run_op(build_command_seq(args), c)
        elif cmd in ("run", "serve"):
            raise NotImplementedError(f"the '{cmd}' command is not ported yet "
                                      "(queued in ROADMAP.md)")
        elif cmd == "legal":
            log_writer.write(LEGAL)
        elif cmd == "version":
            log_writer.write(f"Version {__version__}\n")
        elif cmd in ("help", "?"):
            parser.print_usage()
        else:
            log_writer.write(f"Unknown command '{cmd}'\n\n")
            parser.print_usage()
            return 0
    except Exception as e:  # noqa: BLE001 - CLI error reporting, as the JAX CLI
        log_writer.write(f"Error: {e}\n")
        return -1
    finally:
        if profiler is not None:
            profiler.__exit__(None, None, None)
            os.makedirs(args.trace, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(args.trace, "trace.json"))
        if log_file is not None:
            log_file.flush()

    elapsed = time.time() - start
    log_writer.write(f"\nDone after {elapsed:.2f}s\n")
    if log_file is not None:
        log_file.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
