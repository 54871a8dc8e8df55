"""The port's configuration tree (``stdd_torch/config.py``) against the JAX
package's (``stdd_tpu/config.py``): the same fields and defaults in every
node, ``apply_overrides`` giving equal trees (scalars, bools, tuples,
nested keys) and the same ``KeyError`` for an unknown key, ``load_yaml``
giving equal trees from one YAML file (PyYAML is on this host), and an
``ImportError`` naming PyYAML and ``apply_overrides`` where it is absent."""

import builtins
import dataclasses

import pytest

from stdd_tpu import config as jax_config
from stdd_torch import config

NODES = ("I3DConfig", "DualEncoderConfig", "DetectorConfig", "PipelineConfig", "TrainConfig",
         "MeshConfig", "Config")


def as_dict(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("node", NODES)
def test_nodes_have_jax_fields_and_defaults(node):
    ours, theirs = getattr(config, node), getattr(jax_config, node)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert as_dict(ours()) == as_dict(theirs())
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(ours(), dataclasses.fields(ours)[0].name, None)


OVERRIDES = [
    ["model.num_frames=16"],
    ["model.crop_size=112", "train.base_lr=0.5", "pipeline.threshold=0.4"],
    ["model.fused_s2=true", "dual.use_domain_head=yes", "model.s2d_stem=0"],
    ["model.temp_kernel=[[5], [3], [3, 1], [3, 1], [1, 3]]", "model.spatial_strides=(1, 2, 2, 1)"],
    ["dual.conv_dilations=[1, 3]", "mesh.data_parallel=4", "train.optimizer=sgd",
     "detector.top_k=64"],
]


@pytest.mark.parametrize("items", OVERRIDES, ids=lambda v: v[0].split("=")[0])
def test_apply_overrides_equals_jax(items):
    got = config.apply_overrides(config.Config(), items)
    want = jax_config.apply_overrides(jax_config.Config(), items)
    assert as_dict(got) == as_dict(want)
    assert got != config.Config()


def test_unknown_keys_raise_like_jax():
    for bad in ("model.nope=1", "nope.x=1", "train.base_lr.x=1"):
        with pytest.raises((KeyError, AttributeError)) as ours:
            config.apply_overrides(config.Config(), [bad])
        with pytest.raises((KeyError, AttributeError)) as theirs:
            jax_config.apply_overrides(jax_config.Config(), [bad])
        assert type(ours.value) is type(theirs.value) and str(ours.value) == str(theirs.value)


YAML = """
model:
  num_frames: 16
  crop_size: 112
  temp_kernel: [[5], [3], [3, 1], [3, 1], [1, 3]]
  fused_s2: true
dual:
  conv_dilations: [1, 2]
  d_model: 128
pipeline:
  stride: 15
train:
  base_lr: 0.001
mesh:
  data_parallel: 2
"""


def test_load_yaml_equals_jax(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(YAML)
    for over in (None, ["train.seed=7", "model.num_frames=8"]):
        got = config.load_yaml(str(path), over)
        want = jax_config.load_yaml(str(path), over)
        assert as_dict(got) == as_dict(want)
        assert got.model.temp_kernel == ((5,), (3,), (3, 1), (3, 1), (1, 3))
    empty = tmp_path / "e.yaml"
    empty.write_text("")
    assert as_dict(config.load_yaml(str(empty))) == as_dict(jax_config.load_yaml(str(empty)))


def test_load_yaml_without_pyyaml_names_it(tmp_path, monkeypatch):
    path = tmp_path / "c.yaml"
    path.write_text(YAML)
    real = builtins.__import__

    def no_yaml(name, *a, **kw):
        if name == "yaml" or name.startswith("yaml."):
            raise ImportError("No module named 'yaml'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_yaml)
    with pytest.raises(ImportError, match="PyYAML") as e:
        config.load_yaml(str(path))
    assert "apply_overrides" in str(e.value)
