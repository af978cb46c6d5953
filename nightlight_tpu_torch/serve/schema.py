"""Operator schema export for the web UI, mirror of
nightlight_tpu/serve/schema.py over the port's operator registry.

The reference hand-maintains 39 Blockly block definitions mirroring every
operator (reference: web/js/blocks.js); here the palette is generated from
the operator registry itself, so the UI can never drift from the engine.
The JSON is API surface: it equals the JAX package's, key for key.
"""

from __future__ import annotations

from nightlight_tpu_torch.pipeline.operators import _operator_factories

# Toolbox categories of the reference UI (web/js/toolbox.js).
CATEGORIES = {
    "file": ["load", "loadMany", "save"],
    "pre": ["calibrate", "badPixel", "debayer", "debandHoriz", "debandVert",
            "scaleOffset", "bin", "backExtract", "starDetect"],
    "ref": ["selectRef", "filter", "exportStats"],
    "post": ["matchHist", "align"],
    "stack": ["stack", "stackBatches"],
    "rgb": ["rgbCombine", "rgbBalance", "rgbToHSLuv", "hsluvToRGB"],
    "hsl": ["hslApplyLum", "hslScaleOffsetChannel", "hslNeutralizeBackground",
            "hslSaturationGamma", "hslSelectiveSaturation", "hslRotateHue",
            "hslSCNR", "hslMidtones", "hslGamma", "hslGammaPP",
            "HSLUnsharpMask", "hslScaleBlack", "hslStretch"],
    "stretch": ["normRange", "stretch", "midtones", "gamma", "gammaPP",
                "scaleBlack", "gaussianBlur", "unsharpMask"],
    "seq": ["seq"],
}


# Slider ranges for bounded numeric parameters, mirroring the reference's
# Blockly field_slider bounds (web/js/blocks.js). Keyed by (op, param) for
# op-specific bounds, falling back to the bare param name.
RANGES = {
    ("badPixel", "sigmaLow"): (0, 6, 0.01),
    ("badPixel", "sigmaHigh"): (0, 6, 0.01),
    ("debandHoriz", "percentile"): (0, 100, 0.5),
    ("debandVert", "percentile"): (0, 100, 0.5),
    ("debandHoriz", "sigma"): (0, 10, 0.05),
    ("debandVert", "sigma"): (0, 10, 0.05),
    ("scaleOffset", "scale"): (0, 10, 0.05),
    ("scaleOffset", "offset"): (-10000, 10000, 50),
    ("backExtract", "hfrFactor"): (0, 10, 0.1),
    ("backExtract", "sigma"): (0, 6, 0.01),
    ("backExtract", "clip"): (0, 64, 1),
    ("starDetect", "radius"): (0, 128, 1),
    ("starDetect", "sigma"): (0, 20, 0.1),
    ("starDetect", "badPixelSigma"): (0, 6, 0.01),
    ("starDetect", "inOutRatio"): (0, 20, 0.1),
    ("filter", "minStars"): (0, 500, 1),
    ("align", "k"): (0, 200, 1),
    ("align", "threshold"): (0, 10, 0.05),
    ("stack", "sigmaLow"): (-1, 6, 0.01),
    ("stack", "sigmaHigh"): (-1, 6, 0.01),
    ("stack", "clipPercLow"): (0, 10, 0.05),
    ("stack", "clipPercHigh"): (0, 10, 0.05),
    ("rgbBalance", "block"): (1, 256, 1),
    ("rgbBalance", "border"): (0, 0.5, 0.01),
    ("rgbBalance", "skipBright"): (0, 1, 0.01),
    ("rgbBalance", "skipDim"): (0, 1, 0.01),
    ("hslScaleOffsetChannel", "scale"): (0, 10, 0.05),
    ("hslScaleOffsetChannel", "offset"): (-0.5, 0.5, 0.005),
    ("hslNeutralizeBackground", "sigmaLow"): (0, 5, 0.01),
    ("hslNeutralizeBackground", "sigmaHigh"): (0, 5, 0.01),
    ("hslSaturationGamma", "gamma"): (0, 5, 0.01),
    ("hslSaturationGamma", "sigma"): (0, 5, 0.01),
    ("hslSelectiveSaturation", "from"): (0, 360, 1),
    ("hslSelectiveSaturation", "to"): (0, 360, 1),
    ("hslSelectiveSaturation", "factor"): (0, 5, 0.01),
    ("hslRotateHue", "from"): (0, 360, 1),
    ("hslRotateHue", "to"): (0, 360, 1),
    ("hslRotateHue", "offset"): (-180, 180, 1),
    ("hslRotateHue", "sigma"): (0, 5, 0.01),
    ("hslSCNR", "factor"): (0, 1, 0.01),
    # shared bounds by bare name (stretch family, both plain and hsl variants)
    "location": (0, 1, 0.005),
    "scale": (0, 0.1, 0.001),
    "mid": (0, 5, 0.01),
    "black": (0, 5, 0.01),
    "gamma": (0, 5, 0.01),
    "sigma": (-5, 5, 0.05),
    "gain": (0, 1, 0.01),
    "threshold": (0, 5, 0.01),
}

# Dropdown choices for enumerated parameters (reference field_dropdown
# entries in web/js/blocks.js; values match the engine's IntEnums).
ENUMS = {
    ("selectRef", "target"): [["alignment", 0], ["histogram", 1]],
    ("matchHist", "mode"): [
        ["disabled", 0], ["location (calibration frames)", 1],
        ["location and scale (light frames)", 2],
        ["black point (RGB combination)", 3], ["auto", 4]],
    ("align", "oobMode"): [
        ["not-a-number (for stacking)", 0], ["reference skyfog peak", 1],
        ["this frame's skyfog peak", 2]],
    ("stack", "mode"): [
        ["median (no sigmas)", 0], ["mean (no sigmas)", 1],
        ["sigma-clipped mean", 2], ["winsorized mean", 3],
        ["MAD-sigma mean", 4], ["linear regression fit", 5],
        ["automatic selection", 6]],
    ("stack", "weighting"): [
        ["equally", 0], ["by exposure time", 1],
        ["by inverse noise", 2], ["by inverse HFR", 3]],
    ("save", "saveMode"): [
        ["min..max", 0], ["0..1", 1], ["0..255", 2], ["0..65535", 3]],
    ("hslScaleOffsetChannel", "channelID"): [
        ["Hue", 0], ["Saturation", 1], ["Luminance", 2]],
    ("debayer", "channel"): [["", ""], ["R", "R"], ["G", "G"], ["B", "B"]],
    ("debayer", "colorFilterArray"): [
        ["RGGB", "RGGB"], ["GRBG", "GRBG"], ["GBRG", "GBRG"], ["BGGR", "BGGR"]],
    ("debandHoriz", "window"): [[str(w), w] for w in
                                (8, 16, 32, 64, 96, 128, 192, 256, 384, 512)],
    ("debandVert", "window"): [[str(w), w] for w in
                               (8, 16, 32, 64, 96, 128, 192, 256, 384, 512)],
    ("bin", "binSize"): [["1", 1], ["2", 2], ["3", 3], ["4", 4]],
    ("backExtract", "gridSize"): [[str(g), g] for g in
                                  (0, 32, 64, 128, 256, 512, 1024)],
}


def operator_schema() -> dict:
    """JSON-serializable description of every registered operator."""
    ops = {}
    for t, cls in sorted(_operator_factories.items()):
        params = []
        for field, (json_name, default) in cls.PARAMS.items():
            if hasattr(default, "to_dict"):
                default = default.to_dict()
            kind = "number"
            if isinstance(default, bool):
                kind = "bool"
            elif isinstance(default, str) or default is None:
                kind = "string" if not isinstance(default, (int, float)) else kind
            if isinstance(default, (list, dict)):
                kind = "json"
            p = {"name": json_name, "default": default, "kind": kind}
            enum = ENUMS.get((t, json_name))
            if enum is not None:
                p["enum"] = enum
            elif kind == "number":
                rng = RANGES.get((t, json_name)) or RANGES.get(json_name)
                if rng is not None:
                    p["range"] = list(rng)
            params.append(p)
        doc = (cls.__doc__ or "").strip().split("\n")[0]
        ops[t] = {"params": params, "doc": doc}
    return {"categories": CATEGORIES, "operators": ops}
