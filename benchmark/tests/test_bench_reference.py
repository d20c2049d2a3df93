"""Each plain reference against an independent evaluation of its filter:
a 2-D correlation over the image's interior, where a window does not
wrap, and the port's own plaintext evaluator over every slot."""

import numpy as np
import pytest

from harness.seeding import image_pool


def correlate(img, k):
    """out[r, c] = sum k[i][j] img[r + i, c + j] over the valid region."""
    h, w = img.shape
    out = np.zeros((h - 2, w - 2))
    for i in range(3):
        for j in range(3):
            out += k[i][j] * img[i:i + h - 2, j:j + w - 2]
    return out


SOBEL = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], dtype=float)
BOX = np.ones((3, 3))


def sobel_2d(img):
    gx, gy = correlate(img, SOBEL), correlate(img, SOBEL.T)
    d = gx ** 2 + gy ** 2
    return (d * 2.2137874823876622 + d ** 2 * -1.0984324107372518
            + d ** 3 * 0.17254603006834726)


def harris_2d(img):
    gx, gy = correlate(img, SOBEL), correlate(img, SOBEL.T)
    sxx, syy, sxy = (correlate(a, BOX) for a in (gx * gx, gy * gy, gx * gy))
    return sxx * syy - sxy * sxy - 0.04 * (sxx + syy) ** 2


@pytest.mark.parametrize("name, fn, margin", [("sobel90", sobel_2d, 2),
                                              ("harris64", harris_2d, 4)])
def test_reference_matches_a_2d_filter_inside_the_image(bench, name, fn,
                                                        margin):
    cfg = bench.config(name)
    ref = bench.module("reference", name).reference
    vec = image_pool(5, 1, cfg["rows"], cfg["cols"], cfg["slots"])[0]
    got = ref(vec, cfg)[cfg["output"]]
    img = vec[:cfg["rows"] * cfg["cols"]].reshape(cfg["rows"], cfg["cols"])
    want = fn(img)
    h, w = cfg["rows"] - margin, cfg["cols"] - margin
    got2d = got[:cfg["rows"] * cfg["cols"]].reshape(cfg["rows"], cfg["cols"])
    np.testing.assert_allclose(got2d[:h, :w], want[:h, :w], rtol=1e-12,
                               atol=1e-9)


@pytest.mark.parametrize("name", ["sobel90", "harris64"])
def test_reference_matches_the_ports_plaintext_evaluator(bench, name):
    from eva_tpu_torch import evaluate
    cfg = bench.config(name)
    prog = bench.module("programs", name).build(cfg)
    vec = image_pool(6, 1, cfg["rows"], cfg["cols"], cfg["slots"])[0]
    want = np.asarray(evaluate(prog, {cfg["input"]: vec.tolist()})
                      [cfg["output"]])
    got = bench.module("reference", name).reference(vec, cfg)[cfg["output"]]
    np.testing.assert_allclose(got, want, rtol=1e-11, atol=1e-9)


@pytest.mark.parametrize("name", ["sobel90", "harris64"])
def test_lower_precisions_differ_more_the_lower_they_are(bench, name):
    cfg = bench.config(name)
    ref = bench.module("reference", name).reference
    vec = image_pool(7, 1, cfg["rows"], cfg["cols"], cfg["slots"])[0]
    f64 = ref(vec, cfg)[cfg["output"]]
    e32 = np.abs(ref(vec, cfg, "float32")[cfg["output"]] - f64).max()
    e16 = np.abs(ref(vec, cfg, "bfloat16")[cfg["output"]] - f64).max()
    assert 0 < e32 < e16
    with pytest.raises(ValueError):
        ref(vec, cfg, "float8")
