"""End to end: the 95th percentile, over every frame displayed in the
window, of the time from the input applied to the image on the host (host
clock; linear interpolation between order statistics)."""

import numpy as np


def read(rec):
    lat = rec["latencies_s"]
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) else None
