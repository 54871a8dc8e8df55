"""FTCN-TT served through ``ClipScorer(arch="ftcn_tt")``, on the CPU.

- ``score``, ``score_dense`` and ``score_windows`` against the benchmark's
  plain reference (``portbench/reference/ftcn.py``) on its seeded weights
  (``portbench/lib/ftcn_weights.py``), in probability and logit, at a tiny
  width in float32 through K1's plain version;
- ``return_features`` is the normed cls token the head's last layer reads;
- the head's span ``stdd.scorer.head`` once a forward, nested in
  ``stdd.scorer.trunk``, and ``TemporalConvBN.stride_pools`` 5 a forward;
- ``int8`` takes s3 and s4, ``fused_s2`` is refused, ``--arch`` reaches
  the scorer from the app and the demo, a reference ``.pth`` is refused;
- the benchmark's FTCN-TT work count and its head-span reader.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib.ftcn_flops import ftcn_flops
from portbench.lib.ftcn_weights import make_ftcn_params
from portbench.lib.registry import load_module, metric_readers
from portbench.lib.trace import Trace
from portbench.reference import ftcn as ref
from stdd_torch.config import I3DConfig
from stdd_torch.models import i3d as i3d_mod
from stdd_torch.models.ftcn import TemporalConvBN
from stdd_torch.runtime import classifier
from stdd_torch.runtime.classifier import ClipScorer

BENCH = Path(__file__).resolve().parents[1] / "portbench"
CONFIG = json.loads((BENCH / "configs" / "ftcn_r50.json").read_text())
TINY = dict(depth=18, width_per_group=8, num_frames=8, crop_size=32)
S = 40                       # the crop buffer
STARTS = np.arange(0, 12, 3)
# the program and the reference both compute in float32; what is left is
# rounding (the reference's float64 warp and solve, the summation orders of
# the convolutions and the head's products): a logit within 2e-5 of the
# logit's natural scale (``lib/check.py``), a probability within 1e-5
LOGIT_TOL = 2e-5
PROB_TOL = 1e-5


@pytest.fixture(scope="module")
def served():
    """(scorer, the weights, the spec, a track, the reference's logits and
    features of the windows at ``STARTS``), tiny, float32, on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    model = dict(CONFIG["model"], **TINY)
    head = {k: v for k, v in CONFIG["head"].items() if k not in ("dim", "time_tokens")}
    spec = ref.net_spec(model, head)
    params = make_ftcn_params(spec, 2**35 + 9, "cpu")
    scorer = ClipScorer(params, cfg=I3DConfig(**TINY), dtype=torch.float32,
                        upload_format="yuv420", device="cpu", arch="ftcn_tt")
    dense = load_module(BENCH / "traffic" / "dense.py", "test_ftcn_serve_dense")
    mix = dict(json.loads((BENCH / "traffic" / "dense_ffpp_ftcn.json").read_text()),
               face_px=[14, 18])
    track = dense.make_track(torch.Generator().manual_seed(3), np.random.default_rng(3), 19, S,
                             mix, "cpu")
    T = spec.frames
    windows = [tuple(a[s:s + T] for a in track) for s in STARTS]
    logits, feats = ref.logits_and_features(params, spec, windows, model["bn_eps"], "cpu")
    yield scorer, params, spec, track, logits[:, 0], feats
    torch.set_num_threads(n)


def _logit(p):
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


def _gap(logit, ref_logit, feats, params):
    scale = float(params["head.head_fc.weight"].double().pow(2).mean().sqrt())
    return np.abs(logit - ref_logit) / (scale * np.linalg.norm(feats, axis=1))


@pytest.mark.parametrize("entry", ["score", "score_dense", "score_windows"])
def test_ftcn_scorer_matches_the_reference(served, entry):
    scorer, params, spec, (frames, boxes, lm5), ref_logit, feats = served
    T, B = spec.frames, len(STARTS)
    idx = STARTS[:, None] + np.arange(T)
    if entry == "score_dense":
        probs = scorer.score_dense(frames, boxes, lm5, STARTS, batch=B)
    elif entry == "score":
        probs = scorer.score(frames[idx], boxes[idx], lm5[idx], np.ones(B, bool))
    else:
        windows = [torch.from_numpy(frames[i]) for i in idx]
        probs = np.asarray(scorer.score_windows(windows, boxes[idx], lm5[idx],
                                                np.ones((B, T), np.float32), np.ones(B, bool)))
    assert np.abs(probs - 1 / (1 + np.exp(-ref_logit))).max() < PROB_TOL
    assert _gap(_logit(probs), ref_logit, feats, params).max() < LOGIT_TOL
    assert np.ptp(ref_logit) > 100 * LOGIT_TOL          # the windows score apart


def test_return_features_is_the_normed_cls_token(served):
    scorer, params, spec, (frames, boxes, lm5), ref_logit, ref_feats = served
    idx = STARTS[:, None] + np.arange(spec.frames)
    probs, logits, feats = scorer.score_with_features(frames[idx], boxes[idx], lm5[idx],
                                                      np.ones(len(STARTS), bool))
    assert feats.shape == (len(STARTS), spec.head.dim) and feats.dtype == np.float32
    # the features are what head_fc reads, and the reference's normed cls token
    w, b = params["head.head_fc.weight"].numpy(), params["head.head_fc.bias"].numpy()
    np.testing.assert_allclose(logits, feats @ w.T + b, rtol=1e-5, atol=1e-6)
    assert np.abs(feats - ref_feats).max() < 1e-4 * np.abs(ref_feats).max()
    assert _gap(logits[:, 0].astype(np.float64), ref_logit, ref_feats, params).max() < LOGIT_TOL


def test_head_span_and_stride_pools_a_forward(served):
    scorer, _, spec, (frames, boxes, lm5), _, _ = served
    idx = STARTS[:, None] + np.arange(spec.frames)
    before = TemporalConvBN.stride_pools
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scorer.score(frames[idx], boxes[idx], lm5[idx], np.ones(len(STARTS), bool))
        scorer.score(frames[idx[:2]], boxes[idx[:2]], lm5[idx[:2]], np.ones(2, bool))
    # the stem's pool, then s3's and s4's first block: its branch and shortcut
    assert TemporalConvBN.stride_pools - before == 2 * 5
    ev = {}
    for e in prof.profiler.kineto_results.events():
        ev.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    heads, trunks = ev["stdd.scorer.head"], ev["stdd.scorer.trunk"]
    assert len(heads) == len(trunks) == 2
    assert all(t0 <= h0 and h1 <= t1
               for (h0, h1), (t0, t1) in zip(sorted(heads), sorted(trunks)))


def test_int8_takes_the_stages_ftcn_has_and_fused_s2_is_refused(served):
    scorer, params, spec, (frames, boxes, lm5), ref_logit, feats = served
    q = ClipScorer(params, cfg=I3DConfig(**TINY), dtype=torch.float32, upload_format="yuv420",
                   device="cpu", arch="ftcn_tt", int8=True)
    int8 = [n for n, m in q.model.named_modules()
            if isinstance(m, i3d_mod.Conv3dBN) and m.int8]
    want = [c.name for st in spec.stages[1:]
            for blk in st for c in (blk.a, blk.b, blk.c, blk.shortcut) if c is not None]
    assert sorted(int8) == sorted(want) and len(int8) == 14     # s3 and s4, not s2 nor the stem
    before = i3d_mod.int8_conv_acc.launches
    idx = STARTS[:, None] + np.arange(spec.frames)
    probs = q.score(frames[idx], boxes[idx], lm5[idx], np.ones(len(STARTS), bool))
    assert i3d_mod.int8_conv_acc.launches - before == 14
    gap = _gap(_logit(probs), ref_logit, feats, params)
    assert np.isfinite(gap).all() and gap.max() > 100 * LOGIT_TOL    # quantized: not float32's
    with pytest.raises(ValueError, match="fused_s2"):
        ClipScorer(params, cfg=I3DConfig(fused_s2=True, **TINY), device="cpu", arch="ftcn_tt")
    with pytest.raises(ValueError, match="arch"):
        ClipScorer.random_init(cfg=I3DConfig(**TINY), device="cpu", arch="ftcn")


def test_random_init_draws_the_ftcn(served):
    s = ClipScorer.random_init(cfg=I3DConfig(**TINY), seed=4, dtype=torch.float32,
                               device="cpu", arch="ftcn_tt")
    assert s.cfg.temporal_only and "head.head_fc.weight" in s.model.state_dict()
    assert float(s.model.state_dict()["head.cls_token"].abs().sum()) > 0     # drawn, not zeros


def test_reference_pth_is_refused_for_ftcn(tmp_path):
    path = str(tmp_path / "ftcn.pth")
    with pytest.raises(ValueError, match="released checkpoint"):
        classifier.load_scorer(path, None, 8, arch="ftcn_tt", device="cpu")


@pytest.mark.parametrize("cli", ["app", "demo"])
def test_each_cli_passes_arch_to_the_scorer(cli, monkeypatch, tmp_path):
    from stdd_torch.eval import demo
    from stdd_torch.runtime import app
    from stdd_torch.utils.video_io import write_y4m

    seen = {}

    class Stop(Exception):
        pass

    def fake_load(*a, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(classifier, "load_scorer", fake_load)
    video = str(tmp_path / "real" / "a.y4m")
    (tmp_path / "real").mkdir()
    write_y4m(video, [np.zeros((32, 32, 3), np.uint8)] * 2)
    main, argv = {"app": (app.main, ["--source", video]),
                  "demo": (demo.main, ["--video_root", str(tmp_path)])}[cli]
    with pytest.raises(Stop):
        main(argv + ["--device", "cpu"])
    assert seen["arch"] == "i3d_ori"
    with pytest.raises(Stop):
        main(argv + ["--arch", "ftcn_tt", "--device", "cpu"])
    assert seen["arch"] == "ftcn_tt"


def test_ftcn_flops_of_the_published_shapes():
    """2 × 66.486 GMAC of 43 convolutions and 0.286 GFLOP of the head's
    products a 32x224x224 window; at a small clip, the full widths' count
    is what PyTorch's counter counts on the reference."""
    spec = ref.net_spec(CONFIG["model"], CONFIG["head"])
    assert ftcn_flops(spec) == 133_258_418_176
    assert len(list(ref.tconvs(spec))) == 43
    small = ref.net_spec(dict(CONFIG["model"], num_frames=4, crop_size=32),
                         {k: v for k, v in CONFIG["head"].items() if k != "time_tokens"})
    params = make_ftcn_params(small, 7, "cpu")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref.forward(params, torch.randn(1, 3, 4, 32, 32), small)
    assert fc.get_total_flops() == ftcn_flops(small)


def _trace(spans_ms, kind):
    names = [n for n, _, _ in spans_ms]
    start = np.asarray([int(a * 1e6) for _, a, _ in spans_ms], np.int64)
    end = np.asarray([int(b * 1e6) for _, _, b in spans_ms], np.int64)
    empty = np.zeros(0, np.int64)
    return {"kind": kind, "trace": Trace([], empty, empty, empty, names, start, end, 1.0)}


def test_head_ms_reader():
    reader = metric_readers()["scorer.head_ms.ftcn"]
    assert reader.UNIT == "ms"
    spans = [("portbench.score_dense", 0, 9), ("stdd.scorer.trunk", 0, 4),
             ("stdd.scorer.head", 3, 3.5), ("stdd.scorer.trunk", 5, 9), ("stdd.scorer.head", 8, 9)]
    assert reader.read(_trace(spans, "dense")) == pytest.approx(0.75, abs=1e-9)
    assert reader.read(_trace(spans, "live")) is None
    assert reader.read({"kind": "dense", "trace": None}) is None
    # the I3D (or a program older than the span) records none: nothing to read
    assert reader.read(_trace(spans[:2], "dense")) is None
