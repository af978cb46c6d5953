"""Named pipeline presets and the fused batch preprocess."""
