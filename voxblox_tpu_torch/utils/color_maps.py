"""Intensity -> colour maps (copy of voxblox_tpu/utils/color_maps.py;
reference utils/color_maps.h:12-162): rainbow, inverse rainbow,
grayscale, inverse grayscale, ironbow. Host numpy code."""

from __future__ import annotations

import numpy as np


def _rainbow(h):
    """h in [0,1] -> rgb float [0,1] (color_maps.h rainbowColorMap)."""
    h = np.clip(np.asarray(h, np.float64), 0.0, 1.0)
    s = h * 6.0
    i = np.minimum(np.floor(s).astype(int), 5)  # clamp: h=1 stays magenta
    f = s - i
    one = np.ones_like(f)
    lut = [
        (one, f, 0 * f),
        (1 - f, one, 0 * f),
        (0 * f, one, f),
        (0 * f, 1 - f, one),
        (f, 0 * f, one),
        (one, 0 * f, 1 - f),
    ]
    r = np.choose(i, [lut[k][0] for k in range(6)])
    g = np.choose(i, [lut[k][1] for k in range(6)])
    b = np.choose(i, [lut[k][2] for k in range(6)])
    return np.stack([r, g, b], -1)


def rainbow_color_map(value):
    return (255 * _rainbow(value)).astype(np.uint8)


def inverse_rainbow_color_map(value):
    return rainbow_color_map(1.0 - np.asarray(value))


def grayscale_color_map(value):
    v = (255 * np.clip(np.asarray(value), 0, 1)).astype(np.uint8)
    return np.stack([v, v, v], -1)


def inverse_grayscale_color_map(value):
    return grayscale_color_map(1.0 - np.asarray(value))


# Ironbow control points (color_maps.h IronbowColorMap palette).
_IRONBOW = np.array(
    [
        [0, 0, 0],
        [145, 20, 145],
        [255, 138, 0],
        [255, 230, 40],
        [255, 255, 255],
    ],
    np.float64,
)


def ironbow_color_map(value):
    v = np.clip(np.asarray(value, np.float64), 0.0, 1.0)
    x = v * (len(_IRONBOW) - 1)
    i = np.minimum(np.floor(x).astype(int), len(_IRONBOW) - 2)
    f = (x - i)[..., None]
    rgb = _IRONBOW[i] * (1 - f) + _IRONBOW[i + 1] * f
    return rgb.astype(np.uint8)


COLOR_MAPS = {
    "rainbow": rainbow_color_map,
    "inverse_rainbow": inverse_rainbow_color_map,
    "grayscale": grayscale_color_map,
    "inverse_grayscale": inverse_grayscale_color_map,
    "ironbow": ironbow_color_map,
}
