"""The port's msgpack codec, checkpoint module and ``from_jax_checkpoint``
against flax and the JAX package.

- The codec reads what ``flax.serialization.to_bytes`` and the JAX
  ``save_checkpoint`` write (float32, bfloat16 and integer leaves, numpy
  scalars, empty arrays, an ``opt_state``, chunked leaves), writes the same
  bytes for the same tree, and flax reads what the port writes.
- ``tolerant_merge``, the GC with ``protect=``, ``list_checkpoints`` and
  ``find_last`` behave as the JAX ones.
- ``ClipScorer.from_jax_checkpoint`` (``tests/test_jax_ckpt_serving.py``
  is the model) serves probs equal to the JAX scorer's on the same
  checkpoint (float32, CPU, |Δp| ≤ 1e-4), reads the sidecar geometry and
  refuses checkpoints that do not cover the model.
"""

import json
import os

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from stdd_tpu.config import I3DConfig as JaxI3DConfig
from stdd_tpu.ops.align import STD_POINTS_256
from stdd_tpu.runtime.classifier import ClipScorer as JaxClipScorer
from stdd_tpu.utils import checkpoint as jax_ckpt
from stdd_torch.config import I3DConfig
from stdd_torch.runtime.classifier import ClipScorer
from stdd_torch.utils import checkpoint as ckpt
from stdd_torch.utils import msgpack as mp
from stdd_torch.utils.weights import i3d_flax_to_torch, i3d_torch_to_flax

from torch_port_helpers import jax_i3d_variables

CFG = dict(num_frames=8, crop_size=64)
P_TOL = 1e-4


def _tree(rng):
    """Every leaf kind a trainer checkpoint holds."""
    return {
        "params": {"conv": {"kernel": rng.randn(3, 1, 1, 4, 8).astype(np.float32)},
                   "bn": {"scale": jnp.asarray(rng.randn(8), jnp.bfloat16),
                          "bias": np.zeros((0,), np.float32)}},
        "batch_stats": {"bn": {"mean": rng.randn(8).astype(np.float64)}},
        "opt_state": {"0": {"count": np.int32(7), "mu": rng.randint(-5, 5, (2, 3)).astype(np.int64)},
                      "1": {"lr": np.float32(0.5), "done": np.bool_(True)}},
        "step": 12, "note": None, "ratio": 0.25,
    }


def _assert_same_tree(got, want):
    assert isinstance(got, dict) and set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_same_tree(g, w)
        elif isinstance(w, (np.ndarray, np.generic)) or hasattr(w, "dtype"):
            wn = np.asarray(w)
            if isinstance(g, torch.Tensor):                # bfloat16 leaves
                assert str(wn.dtype) == "bfloat16" and g.dtype == torch.bfloat16
                g = g.float().numpy()
                wn = wn.astype(np.float32)
            else:
                assert np.asarray(g).dtype == wn.dtype and np.ndim(g) == wn.ndim
            np.testing.assert_array_equal(np.asarray(g), wn)
        else:
            assert g == w and type(g) is type(w)


def test_codec_reads_flax_bytes():
    tree = _tree(np.random.RandomState(0))
    raw = serialization.to_bytes(tree)
    _assert_same_tree(mp.msgpack_restore(raw), serialization.msgpack_restore(raw))


def test_codec_writes_flax_bytes_and_flax_reads_them():
    """The same tree gives the same bytes, and flax restores what the port
    writes, leaf for leaf (bfloat16 tensors included)."""
    rng = np.random.RandomState(1)
    tree = _tree(rng)
    restored = mp.msgpack_restore(serialization.to_bytes(tree))   # port leaves: torch bf16
    written = mp.msgpack_serialize(restored)
    assert written == serialization.msgpack_serialize(tree)      # both sort the keys
    _assert_same_tree(mp.msgpack_restore(written), serialization.msgpack_restore(written))
    back = serialization.msgpack_restore(written)
    assert str(back["params"]["bn"]["scale"].dtype) == "bfloat16"
    t = torch.randn(5, 3).to(torch.bfloat16)
    flax_t = serialization.msgpack_restore(mp.packb({"t": t}))["t"]
    np.testing.assert_array_equal(np.asarray(flax_t, np.float32), t.float().numpy())


def test_codec_every_msgpack_type():
    """Lengths and widths the checkpoints rarely reach: str/bin/array/map
    16 and 32, 64-bit ints, float32, nil, bool, complex (flax's ext 2)."""
    obj = {"s8": "x" * 40, "s16": "y" * 300, "s32": "z" * 70000, "b8": b"\x01" * 10,
           "b16": b"\x02" * 300, "b32": b"\x03" * 70000, "a16": list(range(20)),
           "a32": [0] * 70000, "m16": {str(i): i for i in range(20)}, "neg": [-1, -32, -33, -200,
           -40000, -(1 << 40)], "pos": [127, 128, 255, 256, 70000, 1 << 40, (1 << 64) - 1],
           "f": [0.5, -1e300], "t": True, "f0": False, "n": None}
    raw = msgpack.packb(obj, use_bin_type=True)
    assert mp.unpackb(raw) == obj
    assert msgpack.unpackb(mp.packb(obj), raw=False, strict_map_key=False) == obj
    assert mp.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5
    assert mp.msgpack_restore(serialization.msgpack_serialize({"c": 2.0 - 3.5j}))["c"] == 2.0 - 3.5j
    with pytest.raises(TypeError):
        mp.packb(1.0 + 2.0j)                              # read, never written
    with pytest.raises(ValueError):
        mp.unpackb(raw[:-1])


def test_codec_chunked_leaves(monkeypatch):
    """Leaves over flax's chunk size are written as chunked dicts; both
    sides join them back (the threshold is lowered to exercise it)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(mp, "MAX_CHUNK_SIZE", 64)
    a = np.arange(100, dtype=np.float32).reshape(4, 25)
    raw = serialization.msgpack_serialize({"w": a, "small": np.ones(3, np.float32)})
    assert "__msgpack_chunked_array__" in msgpack.unpackb(raw, strict_map_key=False,
                                                          ext_hook=lambda c, d: None)["w"]
    np.testing.assert_array_equal(mp.msgpack_restore(raw)["w"], a)
    written = mp.msgpack_serialize({"w": a, "small": np.ones(3, np.float32)})
    assert written == raw
    np.testing.assert_array_equal(serialization.msgpack_restore(written)["w"], a)


def test_checkpoint_files_interchange(tmp_path):
    """The JAX save_checkpoint's file loads in the port, the port's in the
    JAX load_checkpoint (with a target, as the JAX trainer resumes), and the
    sidecars are the same JSON."""
    tree = _tree(np.random.RandomState(2))
    meta = {"crop_size": 64, "clip_size": 8, "epoch": 3}
    pj = jax_ckpt.save_checkpoint(str(tmp_path / "jax"), "i3d", 3, tree, metadata=meta)
    pt = ckpt.save_checkpoint(str(tmp_path / "torch"), "i3d", 3, mp.msgpack_restore(
        serialization.to_bytes(tree)), metadata=meta)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    assert json.load(open(pj + ".json")) == json.load(open(pt + ".json"))
    _assert_same_tree(ckpt.load_checkpoint(pj), serialization.msgpack_restore(open(pj, "rb").read()))
    back = jax_ckpt.load_checkpoint(pt, tree)
    _assert_same_tree(serialization.to_state_dict(back),
                      serialization.msgpack_restore(open(pj, "rb").read()))


def test_gc_protect_and_resume_match_jax(tmp_path):
    """Rolling max_to_keep GC that spares the protected best epoch and the
    file just written (even an older epoch), as the JAX module keeps them."""
    tree = {"w": np.zeros(3, np.float32)}
    kept = {}
    for side, mod in (("jax", jax_ckpt), ("torch", ckpt)):
        d = str(tmp_path / side)
        for ep in list(range(1, 8)) + [2]:
            path = mod.save_checkpoint(d, "i3d", ep, tree, max_to_keep=3,
                                       protect="i3d_1.msgpack", metadata={"epoch": ep})
            assert os.path.exists(path)
        kept[side] = sorted(os.listdir(d))
        assert mod.find_last(d, "i3d")[0] == 7
        assert [e for e, _ in mod.list_checkpoints(d, "i3d")] == [1, 2, 5, 6, 7]
    assert kept["torch"] == kept["jax"]
    assert "i3d_1.msgpack" in kept["torch"] and "i3d_1.msgpack.json" in kept["torch"]
    assert ckpt.find_last(str(tmp_path / "none"), "i3d") is None


@pytest.mark.parametrize("case", ["exact", "extra_and_missing", "shape", "prefix"])
def test_tolerant_merge_reports_match_jax(case):
    rng = np.random.RandomState(3)
    target = {"a": {"w": np.zeros((2, 3), np.float32), "b": np.zeros(3, np.float32)},
              "c": np.zeros(4, np.float32)}
    source = {"a": {"w": rng.randn(2, 3), "b": rng.randn(3).astype(np.float32)},
              "c": rng.randn(4).astype(np.float32)}
    strip = ()
    if case == "extra_and_missing":
        del source["c"]
        source["opt"] = {"mu": np.ones(2)}
    elif case == "shape":
        source["a"]["b"] = rng.randn(5).astype(np.float32)
    elif case == "prefix":
        source = {"module": source}
        strip = ("module",)
    mj, rj = jax_ckpt.tolerant_merge(target, source, strip)
    mt, rt = ckpt.tolerant_merge(target, source, strip)
    assert {k: sorted(v) for k, v in rt.items()} == {k: sorted(v) for k, v in rj.items()}
    _assert_same_tree(mt, {k: v for k, v in mj.items()})


# -- serving the trainer's checkpoints -------------------------------------------

@pytest.fixture(scope="module")
def variables():
    return jax_i3d_variables(JaxI3DConfig(**CFG), seed=4)


def _batch(rng, B=2):
    T = CFG["num_frames"]
    crops = rng.randint(0, 255, (B, T, 96, 96, 3), np.uint8)
    boxes = np.tile(np.array([10.0, 8.0, 90.0, 92.0], np.float32), (B, T, 1))
    lm5 = np.tile(STD_POINTS_256 * (70.0 / 256.0) + 8.0, (B, T, 1, 1)).astype(np.float32)
    lm5 = lm5 + rng.normal(0, 1.0, lm5.shape).astype(np.float32)
    return crops, boxes, lm5, np.array([True, False][:B])


def _save_jax(tmp_path, variables, **kw):
    tree = {"params": variables["params"], "batch_stats": variables["batch_stats"],
            "opt_state": {"momentum": np.zeros(3, np.float32), "count": np.int32(9)}}
    return jax_ckpt.save_checkpoint(str(tmp_path), "i3d", 7, tree, **kw)


def test_from_jax_checkpoint_matches_jax_scorer(tmp_path, variables):
    """A JAX trainer checkpoint (with opt_state) served by both packages:
    the same probs, and the port's weights equal the checkpoint's."""
    path = _save_jax(tmp_path, variables)
    js = JaxClipScorer.from_jax_checkpoint(path, cfg=JaxI3DConfig(**CFG), dtype=jnp.float32,
                                           use_pallas_warp=False)
    ts = ClipScorer.from_jax_checkpoint(path, cfg=I3DConfig(**CFG), dtype=torch.float32,
                                        device="cpu")
    sd = i3d_flax_to_torch(variables)
    for k, t in ts.model.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), sd[k].numpy(), err_msg=k)
    crops, boxes, lm5, valid = _batch(np.random.RandomState(5))
    want = np.asarray(js.score(crops, boxes, lm5, valid))
    got = ts.score(crops, boxes, lm5, valid)
    assert got[1] == 0.0 and 0.0 < got[0] < 1.0
    assert np.abs(got - want).max() <= P_TOL


def test_port_checkpoint_serves_in_both_packages(tmp_path, variables):
    """The port writes a checkpoint from its own model (through the inverse
    weight bridge); the JAX scorer serves it with the same probs, and the
    port's fused-s2 scorer serves it too."""
    model_sd = i3d_flax_to_torch(variables)
    tree = i3d_torch_to_flax(model_sd)
    path = ckpt.save_checkpoint(str(tmp_path), "i3d", 1, tree,
                                metadata={"crop_size": 64, "clip_size": 8, "temporal_only": False})
    js = JaxClipScorer.from_jax_checkpoint(path, cfg=None, dtype=jnp.float32,
                                           use_pallas_warp=False)
    ts = ClipScorer.from_jax_checkpoint(path, cfg=None, dtype=torch.float32, device="cpu")
    tf = ClipScorer.from_jax_checkpoint(path, cfg=I3DConfig(**CFG, fused_s2=True),
                                        dtype=torch.float32, device="cpu")
    crops, boxes, lm5, valid = _batch(np.random.RandomState(6))
    want = np.asarray(js.score(crops, boxes, lm5, valid))
    assert np.abs(ts.score(crops, boxes, lm5, valid) - want).max() <= P_TOL
    assert np.abs(tf.score(crops, boxes, lm5, valid) - want).max() <= P_TOL


def test_from_jax_checkpoint_reads_sidecar_geometry(tmp_path, variables):
    path = _save_jax(tmp_path, variables, metadata={"crop_size": 64, "clip_size": 8,
                                                   "temporal_only": False, "epoch": 7})
    ts = ClipScorer.from_jax_checkpoint(path, cfg=None, dtype=torch.float32, device="cpu")
    assert (ts.cfg.crop_size, ts.cfg.num_frames) == (64, 8)
    crops, boxes, lm5, valid = _batch(np.random.RandomState(7))
    js = JaxClipScorer.from_jax_checkpoint(path, cfg=None, dtype=jnp.float32,
                                           use_pallas_warp=False)
    assert np.abs(ts.score(crops, boxes, lm5, valid)
                  - np.asarray(js.score(crops, boxes, lm5, valid))).max() <= P_TOL


@pytest.mark.parametrize("how", ["width", "missing_leaf"])
def test_from_jax_checkpoint_refuses(tmp_path, variables, how):
    """Another width (every shape differs) and a missing leaf raise as the
    JAX loader does. (A ``temporal_only`` sidecar is served:
    ``test_torch_ftcn.py``.)"""
    if how == "width":
        path = _save_jax(tmp_path, variables)
        cfg = I3DConfig(**CFG, width_per_group=32)
    else:
        params = dict(variables["params"])
        params["head"] = {"projection": {"kernel": params["head"]["projection"]["kernel"]}}
        path = _save_jax(tmp_path, {"params": params, "batch_stats": variables["batch_stats"]})
        cfg = I3DConfig(**CFG)
    with pytest.raises(ValueError, match="does not cover"):
        ClipScorer.from_jax_checkpoint(path, cfg=cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="does not cover"):
        JaxClipScorer.from_jax_checkpoint(path, cfg=JaxI3DConfig(**CFG, width_per_group=32)
                                          if how == "width" else JaxI3DConfig(**CFG),
                                          dtype=jnp.float32)


@pytest.mark.parametrize("sidecar", ["truncated", "no_crop_size", "no_clip_size", "not_a_dict",
                                     "absent"])
def test_from_jax_checkpoint_sidecar_errors_name_the_sidecar(tmp_path, variables, sidecar):
    """ADVICE.md r5 #3, fixed in the port only: a sidecar that is not JSON,
    or that lacks a geometry key the trainer always writes
    (``stdd_tpu/train/run_i3d.py:347-350``), raises a ``ValueError`` naming
    it instead of a bare ``JSONDecodeError`` or a silent 32/224 fallback.
    With no sidecar at all the defaults hold, as in the JAX package."""
    path = _save_jax(tmp_path, variables, metadata={"crop_size": 64, "clip_size": 8,
                                                   "temporal_only": False})
    meta = {"truncated": '{"crop_size": 64, "clip_si',
            "no_crop_size": json.dumps({"clip_size": 8, "temporal_only": False}),
            "no_clip_size": json.dumps({"crop_size": 64}),
            "not_a_dict": json.dumps([64, 8])}
    if sidecar == "absent":
        os.remove(path + ".json")
        ts = ClipScorer.from_jax_checkpoint(path, dtype=torch.float32, device="cpu")
        assert (ts.cfg.crop_size, ts.cfg.num_frames) == (I3DConfig().crop_size,
                                                         I3DConfig().num_frames)
        return
    with open(path + ".json", "w") as f:
        f.write(meta[sidecar])
    with pytest.raises(ValueError, match=r"sidecar .*\.json"):
        ClipScorer.from_jax_checkpoint(path, dtype=torch.float32, device="cpu")
