"""The numpy PNG reader + bilinear resize against cv2 on every committed
map, at the resolutions its configs use (env/maps.py reproduces
``cv2.imread(IMREAD_GRAYSCALE)`` + ``cv2.resize`` bit for bit there)."""

import os

import numpy as np
import pytest

from img_env_tpu.env import maps

MAP_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "img_env_tpu", "maps")

# (map file, global resolution, view resolution): the shipped configs and
# bench scenes read every non-BARN map at 0.1 -> 0.015 m; BARN worlds are
# 0.15 m cells read at 0.05 m (datasets/barn.world_cfg_dict); the training
# configs also read room_10 at 0.1 -> 0.1 m (no resize)
CASES = [(f, 0.1, 0.015) for f in (
    "corridor.png", "corridor2.png", "corridor3.png", "long_corridor2.png",
    "room_10.png", "room_16_empty.png", "room_s_corridor2.png")] + [
    (f"barn_world_{i}.png", 0.15, 0.05) for i in range(3)]


@pytest.mark.parametrize("fname,g_res,v_res", CASES)
def test_map_load_matches_cv2(fname, g_res, v_res):
    cv2 = pytest.importorskip("cv2")
    path = os.path.join(MAP_DIR, fname)
    ref = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    img = maps.read_png_gray(path)
    np.testing.assert_array_equal(img, ref)
    h = int(ref.shape[0] * g_res / v_res)
    w = int(ref.shape[1] * g_res / v_res)
    np.testing.assert_array_equal(maps.resize_linear_u8(img, w, h),
                                  cv2.resize(ref, (w, h)))
    np.testing.assert_array_equal(maps._load_resized(path, g_res, v_res),
                                  cv2.resize(ref, (w, h)))


def test_read_png_gray_colour_and_alpha(tmp_path):
    """RGB and RGBA pixels convert like cv2's grayscale read (alpha is
    dropped), and unsupported PNGs are refused."""
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    for ch in (3, 4):
        p = str(tmp_path / f"c{ch}.png")
        cv2.imwrite(p, rng.integers(0, 256, (17, 23, ch)).astype(np.uint8))
        np.testing.assert_array_equal(
            maps.read_png_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    p16 = str(tmp_path / "d16.png")
    cv2.imwrite(p16, np.zeros((4, 4), np.uint16))
    with pytest.raises(ValueError, match="8-bit"):
        maps.read_png_gray(p16)
