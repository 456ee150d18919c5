"""One viewer client flying down the road: ``x`` advances by ``step_m`` a
frame from ``x0`` (wrapping at ``x1``), at ``height``; the lane offset,
yaw and pitch sway smoothly, as a user steers: sines of amplitude
``lane_m``, ``yaw_deg`` (about ``heading_deg``) and ``pitch_deg`` (about
``pitch0_deg``), periods ``lane_period``, ``yaw_period`` and
``pitch_period`` frames, phases ``lane_phase``, ``yaw_phase`` and
``pitch_phase`` (radians).  Every seed flies the same path: the seed
changes the scene, not the work of the path.  A request is
``{"pos", "yaw", "pitch"}``."""

import math

import numpy as np


def more(mix: dict, rng, n_views: int, i: int) -> list:
    """Frame ``i``."""
    m = mix

    def sway(key):
        return m[key + "_" + ("m" if key == "lane" else "deg")] * math.sin(
            2 * math.pi * i / m[key + "_period"] + m[key + "_phase"])

    x = m["x0"] + (i * m["step_m"]) % (m["x1"] - m["x0"])
    pos = np.array([x, sway("lane"), m["height"]])
    yaw = math.radians(m["heading_deg"] + sway("yaw"))
    pitch = math.radians(m["pitch0_deg"] + sway("pitch"))
    return [{"pos": pos, "yaw": yaw, "pitch": pitch}]
