"""device.idle: the share of the profiled jobs' wall in which no kernel, copy
or set ran on the card (1 less the union of the device's busy intervals over
the wall), in %."""


def read(rec):
    if not rec.get("window_s") or not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
