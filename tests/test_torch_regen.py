"""The port's robustness dataset against the JAX package's
(``stdd_torch/data/regen.py`` vs ``stdd_tpu/data/regen.py``) on two
``.y4m`` videos, ``original/`` and ``deepfakes/``.

JAX's ``read_frames_strided`` decodes through ``cv2.VideoCapture``, whose
``.y4m`` decode lies up to 3 grey levels from the port's (bit-equal to
``cvtColor``). So the strided read is compared with ``cv2.VideoCapture``
patched to the port's reader, and the dataset with JAX's
``read_frames_strided`` patched to the port's (this test only); the
decoders are not compared. The landmarker is the fake one of
``tests/test_data.py:236``; the AU extractors are the port's at random
init and JAX's with the same weights through the flax bridge.

Tolerances: ``L``, ``lengths``, ``y``, ``tech`` and the ids equal (the
degradations, the face crop and its resize are bit-equal); ``A`` within
``AU_TOL`` = 1e-4 (float32 convolutions summed in another order; the
binarised AUs are then equal unless an activation lies within 1e-4 of the
0.5 threshold).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stdd_tpu.data.regen as J
import stdd_tpu.models.au_resnet as JAU
import stdd_torch.data.regen as P
from stdd_torch.models.au_resnet import AUExtractor
from stdd_torch.utils.video_io import write_y4m
from stdd_torch.utils.weights import torch_to_flax

from torch_port_helpers import install_y4m_capture

AU_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # six test processes share the host's cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def videos(tmp_path_factory):
    root = tmp_path_factory.mktemp("regen")
    rng = np.random.RandomState(0)
    paths = []
    for tech in ("original", "deepfakes"):
        (root / tech).mkdir()
        p = str(root / tech / "v.y4m")
        write_y4m(p, [rng.randint(0, 255, (120, 160, 3)).astype(np.uint8) for _ in range(30)])
        paths.append(p)
    return paths


def fake_landmarker(frame_rgb):
    r = np.random.RandomState(int(frame_rgb[0, 0, 0]))
    return r.uniform(0.2, 0.8, (478, 2)).astype(np.float32) * 100


@pytest.fixture(scope="module")
def extractors():
    port = AUExtractor.random_init(seed=0, device="cpu")
    variables = jax.tree_util.tree_map(jnp.asarray, torch_to_flax(port.model.state_dict()))
    return port, JAU.AUExtractor(variables)


@pytest.mark.parametrize("T,stride,start", [(8, 2, 0), (8, 2, 7), (5, 3, 2), (20, 2, 0), (0, 2, 0)])
def test_read_frames_strided_matches_jax(videos, monkeypatch, T, stride, start):
    install_y4m_capture(monkeypatch)
    got = P.read_frames_strided(videos[0], T, stride, start)
    want = J.read_frames_strided(videos[0], T, stride, start)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_au,is_train", [(False, True), (True, True), (True, False)],
                         ids=["no_au", "au_train", "au_eval"])
def test_dataset_matches_jax(videos, extractors, monkeypatch, with_au, is_train):
    monkeypatch.setattr(J, "read_frames_strided", P.read_frames_strided)
    port_au, jax_au = extractors if with_au else (None, None)
    kw = dict(landmarker=fake_landmarker, T=8, is_train=is_train, seed=1)
    ds = P.DualVideoRegenDataset(videos, au_extractor=port_au, **kw)
    jds = J.DualVideoRegenDataset(videos, au_extractor=jax_au, **kw)
    assert len(ds) == len(jds) == 2 and ds.labels == jds.labels == [0, 1]
    assert ds.tech_names == jds.tech_names
    got, want = ds.load_all(), jds.load_all()
    assert sorted(got) == sorted(want)
    for k in ("L", "lengths", "y", "dom_id", "trk", "vid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert got["tech"] == want["tech"]
    assert got["A"].shape == want["A"].shape == (2, 8, 36)
    np.testing.assert_allclose(got["A"], want["A"], atol=AU_TOL)
    assert (got["lengths"] >= 1).all()
    if not with_au:
        assert got["A"].sum() == 0          # zero AUs without an extractor (reference :239)
    else:
        assert 0 < got["A"][..., :12].mean() < 1
    # the generators end where JAX's end: the next item is the same too
    np.testing.assert_array_equal(ds[1]["L"], jds[1]["L"])


def test_face_crop_and_resize_match_jax():
    frame = np.random.RandomState(4).randint(0, 256, (90, 130, 3)).astype(np.uint8)
    for pts in (np.array([[10.0, 20.0], [60.5, 70.2]]), np.array([[-30.0, -5.0], [200.0, 95.0]]),
                np.array([[40.0, 40.0], [40.4, 40.2]])):
        crop = P._face_crop(frame, pts)
        np.testing.assert_array_equal(crop, J._face_crop(frame, pts))
        np.testing.assert_array_equal(P._resize256(crop[:, :, ::-1]), J._resize256(crop[:, :, ::-1]))
