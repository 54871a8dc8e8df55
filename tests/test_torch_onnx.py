"""The port's ONNX reader and executor against the JAX package.

- ``encode_onnx`` (``stdd_torch/utils/onnx_writer.py``, numpy only) writes
  ONNX bytes; ``stdd_torch.utils.onnx_reader.load_onnx`` and
  ``stdd_tpu.utils.onnx_reader.load_onnx`` read the same file into the same
  nodes, attributes, dtypes, shapes and initializer bytes, for tensors in
  ``raw_data`` and in the typed fields.
- ``stdd_torch.models.onnx_torch.OnnxModule`` against
  ``stdd_tpu.models.onnx_jax.OnnxModule``, both built from the same bytes,
  on one small graph per case: every one of the 29 op handlers, with conv
  groups, pads, strides and dilation, both pools with ``ceil_mode``,
  Resize in every branch up and down, Gemm's transposes, alpha and beta,
  Squeeze/Unsqueeze with axes as attribute and as input, and a host-folded
  shape subgraph. Tolerance: 1e-5 relative (of max(1, max |JAX|)) for
  arithmetic, exact for layout ops.
"""

import numpy as np
import pytest
import torch

from stdd_tpu.models.onnx_jax import OnnxModule as JaxOnnxModule
from stdd_tpu.utils.onnx_reader import load_onnx as jax_load_onnx
from stdd_torch.models.onnx_torch import OnnxModule
from stdd_torch.utils.onnx_reader import OnnxGraph, OnnxNode, load_onnx
from stdd_torch.utils.onnx_writer import write_onnx, yunet_shaped_graph

from torch_port_helpers import max_rel_err

REL_TOL = 1e-5
F32 = np.float32


def _graph(nodes, inits, inputs, outputs, shapes=None):
    return OnnxGraph("case", [OnnxNode(op, f"n{i}", ins, outs, attrs)
                              for i, (op, ins, outs, attrs) in enumerate(nodes)],
                     inits, list(inputs), list(outputs), shapes or {})


def _one(op, n_in=1, **attrs):
    """A graph of one node reading inputs x0..x{n_in-1} into output y."""
    return [(op, [f"x{i}" for i in range(n_in)], ["y"], attrs)]


def _rand(rng, *shape):
    return rng.randn(*shape).astype(F32)


def _cases():
    """name → (nodes, initializers, {input: array}, exact)."""
    r = np.random.RandomState(0)
    x = _rand(r, 2, 4, 9, 11)
    c = {}

    def add(name, nodes, inits, feeds, exact=False):
        c[name] = (nodes, inits, feeds, exact)

    # convolutions (x0 = input, initializers w and b)
    for name, cin, cout, attrs in (
            ("conv", 4, 6, dict(kernel_shape=[3, 3], pads=[1, 1, 1, 1])),
            ("conv_groups_strides", 4, 6, dict(kernel_shape=[3, 3], strides=[2, 2], group=2,
                                               pads=[1, 1, 1, 1])),
            ("conv_asym_pads_dilation", 4, 5, dict(kernel_shape=[3, 2], pads=[0, 1, 2, 0],
                                                   dilations=[2, 1])),
            ("conv_depthwise", 4, 4, dict(kernel_shape=[3, 3], group=4, pads=[1, 1, 1, 1]))):
        g = attrs.get("group", 1)
        w = _rand(r, cout, cin // g, *attrs["kernel_shape"])
        add(name, [("Conv", ["x0", "w", "b"], ["y"], attrs)], {"w": w, "b": _rand(r, cout)},
            {"x0": x})
    add("conv_no_bias", [("Conv", ["x0", "w"], ["y"], dict(kernel_shape=[1, 1]))],
        {"w": _rand(r, 3, 4, 1, 1)}, {"x0": x})
    # elementwise
    add("relu", _one("Relu"), {}, {"x0": x}, exact=True)
    add("leakyrelu", _one("LeakyRelu", alpha=0.2), {}, {"x0": x})
    add("sigmoid", _one("Sigmoid"), {}, {"x0": x})
    add("softmax", _one("Softmax", axis=1), {}, {"x0": x})
    add("exp", _one("Exp"), {}, {"x0": x})
    for op in ("Add", "Sub", "Mul", "Div"):
        add(op.lower(), [(op, ["x0", "k"], ["y"], {})],
            {"k": (r.uniform(0.5, 2.0, (1, 4, 1, 1))).astype(F32)}, {"x0": x})
    add("add_broadcast_inputs", _one("Add", 2), {}, {"x0": x, "x1": _rand(r, 11)})
    # pools: odd sizes so ceil_mode adds a window
    for name, op, attrs in (
            ("maxpool", "MaxPool", dict(kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1])),
            ("maxpool_ceil", "MaxPool", dict(kernel_shape=[2, 2], strides=[2, 2], ceil_mode=1)),
            ("averagepool", "AveragePool", dict(kernel_shape=[3, 3], strides=[2, 2])),
            ("averagepool_pads", "AveragePool", dict(kernel_shape=[3, 3], strides=[2, 2],
                                                     pads=[1, 1, 1, 1])),
            ("averagepool_ceil", "AveragePool", dict(kernel_shape=[2, 2], strides=[2, 2],
                                                     ceil_mode=1)),
            ("averagepool_include_pad", "AveragePool", dict(kernel_shape=[3, 3], strides=[1, 1],
                                                            pads=[1, 1, 1, 1],
                                                            count_include_pad=1))):
        add(name, _one(op, **attrs), {}, {"x0": x}, exact=(op == "MaxPool"))
    add("globalaveragepool", _one("GlobalAveragePool"), {}, {"x0": x})
    # layout
    add("transpose", _one("Transpose", perm=[0, 2, 3, 1]), {}, {"x0": x}, exact=True)
    add("reshape", [("Reshape", ["x0", "s"], ["y"], {})],
        {"s": np.array([0, -1, 11], np.int64)}, {"x0": x}, exact=True)
    # Shape → Gather → Unsqueeze → Concat → Reshape, folded on the host
    add("reshape_shape_subgraph",
        [("Shape", ["x0"], ["sh"], {}),
         ("Gather", ["sh", "i0"], ["n"], dict(axis=0)),
         ("Unsqueeze", ["n"], ["n1"], dict(axes=[0])),
         ("Concat", ["n1", "m1"], ["s"], dict(axis=0)),
         ("Reshape", ["x0", "s"], ["y"], {})],
        {"i0": np.array(0, np.int64), "m1": np.array([-1], np.int64)}, {"x0": x}, exact=True)
    add("flatten", _one("Flatten", axis=2), {}, {"x0": x}, exact=True)
    add("concat", _one("Concat", 2, axis=1), {}, {"x0": x, "x1": _rand(r, 2, 3, 9, 11)},
        exact=True)
    # Resize: every branch of onnx_jax.py:215-242, up and down
    for name, mode, how, val, exact in (
            ("resize_nearest_x2", "nearest", "scales", [1, 1, 2, 2], True),
            ("resize_nearest_up", "nearest", "sizes", [2, 4, 13, 17], True),
            ("resize_nearest_down", "nearest", "sizes", [2, 4, 6, 7], True),
            ("resize_linear_up", "linear", "scales", [1, 1, 1.5, 2.0], False),
            ("resize_linear_down", "linear", "sizes", [2, 4, 4, 5], False),
            ("resize_linear_up_down", "linear", "sizes", [2, 4, 20, 6], False)):
        inits = {"scales": np.array(val, F32)} if how == "scales" else {
            "scales": np.zeros((0,), F32), "sizes": np.array(val, np.int64)}
        ins = ["x0", "", "scales"] + (["sizes"] if how == "sizes" else [])
        add(name, [("Resize", ins, ["y"], dict(mode=mode))], inits, {"x0": x}, exact=exact)
    # matrix products
    a, b2, cc = _rand(r, 5, 7), _rand(r, 7, 3), _rand(r, 3)
    add("gemm", _one("Gemm", 3), {}, {"x0": a, "x1": b2, "x2": cc})
    add("gemm_trans_alpha_beta", _one("Gemm", 3, transA=1, transB=1, alpha=0.5, beta=2.0), {},
        {"x0": a.T.copy(), "x1": b2.T.copy(), "x2": cc})
    add("matmul", _one("MatMul", 2), {}, {"x0": _rand(r, 2, 5, 7), "x1": b2})
    add("batchnormalization", [("BatchNormalization", ["x0", "s", "b", "m", "v"], ["y"],
                                dict(epsilon=1e-3))],
        {"s": _rand(r, 4), "b": _rand(r, 4), "m": _rand(r, 4),
         "v": r.uniform(0.5, 2.0, 4).astype(F32)}, {"x0": x})
    add("clip_attrs", _one("Clip", min=-0.5, max=0.7), {}, {"x0": x}, exact=True)
    add("clip_inputs", [("Clip", ["x0", "lo", "hi"], ["y"], {})],
        {"lo": np.array(-0.3, F32), "hi": np.array(0.4, F32)}, {"x0": x}, exact=True)
    add("identity", _one("Identity"), {}, {"x0": x}, exact=True)
    add("shape", _one("Shape"), {}, {"x0": x}, exact=True)
    add("gather_host_index", [("Gather", ["x0", "i"], ["y"], dict(axis=1))],
        {"i": np.array([3, 0, -1], np.int64)}, {"x0": x}, exact=True)
    add("gather_device_index", [("Gather", ["x0", "i"], ["y"], dict(axis=3))],
        {"i": r.randint(0, 11, (4, 5)).astype(np.int64)}, {"x0": x}, exact=True)
    add("unsqueeze_attr", _one("Unsqueeze", axes=[0, 3]), {}, {"x0": x}, exact=True)
    add("unsqueeze_input", [("Unsqueeze", ["x0", "ax"], ["y"], {})],
        {"ax": np.array([1], np.int64)}, {"x0": x}, exact=True)
    x1 = _rand(r, 2, 1, 9, 1)
    add("squeeze_attr", _one("Squeeze", axes=[1]), {}, {"x0": x1}, exact=True)
    add("squeeze_all", _one("Squeeze"), {}, {"x0": x1}, exact=True)
    # axes as an input: the JAX handler squeezes every unit axis, which is
    # the named axis here (its only unit axis)
    add("squeeze_input", [("Squeeze", ["x0", "ax"], ["y"], {})],
        {"ax": np.array([1], np.int64)}, {"x0": _rand(r, 2, 1, 9, 11)}, exact=True)
    add("cast", _one("Cast", to=6), {}, {"x0": x * 10}, exact=True)
    add("slice", [("Slice", ["x0", "st", "en", "ax", "sp"], ["y"], {})],
        {"st": np.array([1, 2], np.int64), "en": np.array([2 ** 31 - 1, 9], np.int64),
         "ax": np.array([1, 3], np.int64), "sp": np.array([2, 3], np.int64)}, {"x0": x},
        exact=True)
    add("slice_negative_step", [("Slice", ["x0", "st", "en", "ax", "sp"], ["y"], {})],
        {"st": np.array([-1], np.int64), "en": np.array([-100], np.int64),
         "ax": np.array([2], np.int64), "sp": np.array([-2], np.int64)}, {"x0": x}, exact=True)
    return c


CASES = _cases()
OPS = ("conv relu leakyrelu sigmoid softmax exp add sub mul div maxpool averagepool "
       "globalaveragepool transpose reshape flatten concat resize gemm matmul "
       "batchnormalization clip identity shape gather unsqueeze squeeze cast slice").split()


def _modules(tmp_path, graph, name="g.onnx", raw=True):
    """Both packages' executors, each over its own reader's parse of one file."""
    path = write_onnx(graph, str(tmp_path / name), raw=raw)
    return JaxOnnxModule(jax_load_onnx(path)), OnnxModule(load_onnx(path), device="cpu")


def test_cases_cover_every_op_handler():
    handlers = sorted(n[4:] for n in dir(OnnxModule) if n.startswith("_op_"))
    jax_handlers = sorted(n[4:] for n in dir(JaxOnnxModule) if n.startswith("_op_"))
    assert handlers == jax_handlers == sorted(OPS) and len(OPS) == 29
    used = {op.lower() for nodes, *_ in CASES.values() for op, *_ in nodes}
    assert used == set(OPS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_executor_matches_jax(tmp_path, case):
    nodes, inits, feeds, exact = CASES[case]
    graph = _graph(nodes, inits, list(feeds), ["y"])
    jm, tm = _modules(tmp_path, graph)
    want = np.asarray(jm(**feeds)["y"])
    got = tm(**{k: torch.from_numpy(v) for k, v in feeds.items()})["y"]
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    if exact:
        np.testing.assert_array_equal(got, want.astype(got.dtype))
    else:
        assert got.dtype == np.float32
        assert max_rel_err(got, want) <= REL_TOL


def test_shape_subgraph_folds_on_the_host(tmp_path):
    """The shape values of a Shape→Gather→Unsqueeze→Concat chain stay numpy
    (no device tensor, no wait), and small int initializers stay numpy
    while weights become buffers on the module's device."""
    nodes, inits, feeds, _ = CASES["reshape_shape_subgraph"]
    graph = _graph(nodes, inits, list(feeds), ["s", "y"])
    _, tm = _modules(tmp_path, graph)
    out = tm(torch.from_numpy(feeds["x0"]))
    assert isinstance(out["s"], np.ndarray) and out["s"].tolist() == [2, -1]
    nodes, inits, feeds, _ = CASES["conv"]
    _, tm = _modules(tmp_path, _graph(nodes, inits, ["x0"], ["y"]), name="c.onnx")
    assert {n for n, _ in tm.named_buffers()} == {"init_0", "init_1"}


def test_unknown_op_names_itself(tmp_path):
    graph = _graph(_one("Einsum", equation="ij->ji"), {}, ["x0"], ["y"])
    _, tm = _modules(tmp_path, graph)
    with pytest.raises(NotImplementedError, match="Einsum"):
        tm(torch.zeros(2, 2))


@pytest.mark.parametrize("raw", [True, False], ids=["raw_data", "typed_fields"])
def test_reader_matches_jax_reader(tmp_path, raw):
    """Both readers on one file: the YuNet-shaped graph (its initializers,
    Conv/MaxPool/Resize/Transpose/Reshape attributes and the declared input
    shape) plus a node carrying every attribute kind."""
    graph = yunet_shaped_graph(seed=3)
    graph.nodes.append(OnnxNode("Custom", "every_attr", ["input", ""], ["extra"], dict(
        f=0.25, i=-3, s="text", t=np.arange(6, dtype=np.int32).reshape(2, 3),
        floats=[1.5, -2.0], ints=[-1, 0, 2 ** 40], strings=["a", "bc"])))
    graph.initializers.update({
        "u8": np.arange(5, dtype=np.uint8), "neg_i64": np.array([-5, 7], np.int64),
        "scalar": np.array(2.5, F32), "f16": np.ones((2, 2), np.float16),
        "flag": np.array([True, False])})
    graph.input_shapes["input"] = (None, 3, 320, 320)
    path = write_onnx(graph, str(tmp_path / "r.onnx"), raw=raw)
    got, want = load_onnx(path), jax_load_onnx(path)
    assert (got.name, got.inputs, got.outputs, got.input_shapes) == (
        want.name, want.inputs, want.outputs, want.input_shapes)
    assert got.input_shapes["input"] == (None, 3, 320, 320)
    assert got.outputs == graph.outputs
    assert len(got.nodes) == len(want.nodes) == len(graph.nodes)
    for g, w, src in zip(got.nodes, want.nodes, graph.nodes):
        assert (g.op_type, g.name, g.inputs, g.outputs) == (w.op_type, w.name, w.inputs,
                                                            w.outputs)
        assert (g.op_type, g.inputs) == (src.op_type, src.inputs)
        assert sorted(g.attrs) == sorted(w.attrs) == sorted(src.attrs)
        for k, v in g.attrs.items():
            if isinstance(v, np.ndarray):
                assert v.dtype == w.attrs[k].dtype
                np.testing.assert_array_equal(v, w.attrs[k])
                np.testing.assert_array_equal(v, src.attrs[k])
            else:
                assert v == w.attrs[k] == src.attrs[k]
    assert list(got.initializers) == list(want.initializers) == list(graph.initializers)
    for k, v in got.initializers.items():
        w = want.initializers[k]
        assert v.dtype == w.dtype and v.shape == w.shape
        assert v.tobytes() == w.tobytes()
        src = graph.initializers[k]
        assert v.shape == src.shape
        np.testing.assert_array_equal(v, src.astype(v.dtype))
