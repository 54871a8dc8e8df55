"""The port's rendered talking-heads scene against the JAX package
(``stdd_torch/eval/bench_scene.py`` vs ``stdd_tpu/eval/bench_scene.py``).

Tolerances: frames ≤ 2 grey levels (one from the float32 render's
truncation to uint8, one from the sprites' INTER_LINEAR upscale, which the
port computes in float32 on cv2's sample grid); measured here ≤ 1 on
0.5-0.8% of the values. The background's INTER_CUBIC field is held to
``cv2.resize`` at ≤ 1e-4 and the background itself is equal.
"""

import numpy as np
import pytest

from stdd_tpu.eval.bench_scene import BenchScene as JScene
from stdd_torch.eval.bench_scene import BenchScene, resize_cubic_f32
from stdd_torch.models.facemesh import LM5_DENSE_IDX

cv2 = pytest.importorskip("cv2", reason="cv2 is the JAX scene's resize")


@pytest.fixture(scope="module")
def scenes():
    return (JScene((240, 320), n_faces=2, seed=0),
            BenchScene((240, 320), n_faces=2, seed=0, device="cpu"))


def test_cubic_field_matches_cv2():
    a = np.random.RandomState(0).uniform(-25, 25, (18, 32)).astype(np.float32)
    for h, w in [(240, 320), (1080, 1920), (9, 16)]:
        np.testing.assert_allclose(resize_cubic_f32(a, h, w),
                                   cv2.resize(a, (w, h), interpolation=cv2.INTER_CUBIC),
                                   atol=1e-4)


def test_frames_match_jax(scenes):
    js, ts = scenes
    assert ts.face_px == js.face_px and ts.sprites.shape == js.sprites.shape
    np.testing.assert_array_equal(ts.bg, js.bg)
    shares = []
    for i in (0, 5, 13, 40, 41, 42, 43, 44, 45, 46, 47, 48, 90):
        want, got = js.frame(i, copy=True), ts.frame(i, copy=True)
        d = np.abs(got.astype(int) - want)
        assert d.max() <= 2, (i, d.max())
        shares.append((d > 0).mean())
    assert max(shares) < 0.02, shares
    np.testing.assert_array_equal(ts._positions(77), js._positions(77))


def test_expr_order_validation():
    with pytest.raises(ValueError, match="permutation"):
        BenchScene((120, 160), n_faces=1, loop=4, expr_order=[0, 1, 1, 3], device="cpu")
    with pytest.raises(ValueError, match="permutation"):
        BenchScene((120, 160), n_faces=1, loop=4, expr_order=[0, 1, 2], device="cpu")
    s = BenchScene((120, 160), n_faces=1, loop=4, expr_order=[3, 2, 1, 0], device="cpu")
    plain = BenchScene((120, 160), n_faces=1, loop=4, device="cpu")
    # the expression index is permuted; positions stay smooth in i
    x, y = s._positions(0).astype(int)[0]
    px = s.face_px
    np.testing.assert_array_equal(s.frame(0, copy=True)[y:y + px, x:x + px], plain.sprites[0, 3])
    np.testing.assert_array_equal(s._positions(5), plain._positions(5))


def test_oracle_rows_lie_inside_the_face_sprites(scenes):
    _, ts = scenes
    px = ts.face_px
    for i in (0, 7, 33):
        rows = ts.oracle(i)
        assert rows.shape == (2, 15) and rows.dtype == np.float32
        assert (rows[:, 14] == 1.0).all()
        pos = ts._positions(i).astype(int)
        for f in range(2):
            x, y, w, h = rows[f, :4]
            x0, y0 = pos[f]
            # the jaw of an open mouth reaches up to 2.5% of a sprite past
            # its bottom edge (the face oval spans 0.09-0.99 of the box)
            assert x0 <= x and y0 <= y and x + w <= x0 + px and y + h <= y0 + 1.03 * px
            lm5 = rows[f, 4:14].reshape(5, 2)
            assert ((lm5 >= pos[f]) & (lm5 <= pos[f] + px)).all()
            assert 0.5 * px < h < 1.03 * px and 0.4 * px < w < px
            assert ((lm5 >= [x, y]) & (lm5 <= [x + w, y + h])).all()
            np.testing.assert_allclose(lm5, ts.mesh(i)[f, list(LM5_DENSE_IDX)], atol=1e-4)
            # eyes above the nose above the mouth
            assert lm5[:2, 1].max() < lm5[2, 1] < lm5[3:, 1].min()
