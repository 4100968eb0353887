"""The port's config system (``proben_tpu_torch/config``) against
``proben_tpu.config``: the YAML files, command-line overrides, VERSION
migration and the typed configs. Everything here is exact: the same values
of the same types, or the same error.

The port reads YAML with its own reader (``config/yaml_subset.py``; the
card's machine need not have PyYAML); PyYAML is imported here only as the
reference for that reader.
"""

import dataclasses
import glob
import math
import os

import pytest
import yaml

from proben_tpu.config import get_cfg as jax_get_cfg
from proben_tpu.config import mapper_config_from_cfg as jax_mapper_config_from_cfg
from proben_tpu.config import model_config_from_cfg as jax_model_config_from_cfg
from proben_tpu.config import solver_config_from_cfg as jax_solver_config_from_cfg
from proben_tpu_torch.config import (
    CfgNode,
    get_cfg,
    mapper_config_from_cfg,
    model_config_from_cfg,
    solver_config_from_cfg,
)
from proben_tpu_torch.config import yaml_subset
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

ROOT = os.path.join(os.path.dirname(__file__), "..")
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
# typical values of ``merge_from_list`` overrides
CLI_VALUES = ["0.5", "1e-3", "1.0e-3", ".5", "-3", "+4", "0", "1_000", "[800, 1024]",
              "[[32], [64], [128]]", "[0.5, 1.0, 2.0]", "[]", "True", "false", "yes", "Off",
              "null", "~", "", "abc", "relative_range", "'quoted'", '"double \\"q\\""',
              "build_resnet_fpn_backbone", ".inf", "-.inf", "a b c", "[a, 'b', \"c\"]",
              "./output", "FLIR_val", "[\"bbox\", \"AP\", 100.0, 0.02]", "3 # a comment"]


def plain(node):
    return {k: plain(v) if isinstance(v, dict) else v for k, v in node.items()}


def _both(path):
    jc, tc = jax_get_cfg(), get_cfg()
    jc.merge_from_file(path)
    tc.merge_from_file(path)
    return jc, tc


def test_nine_config_files():
    assert len(YAMLS) == 9, YAMLS


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, ROOT))
def test_yaml_files_give_equal_cfgnodes(path):
    """``_BASE_`` chains and VERSION included; the trees are equal except
    MODEL.DEVICE, which names the port's device."""
    jc, tc = _both(path)
    a, b = plain(jc), plain(tc)
    assert (a["MODEL"].pop("DEVICE"), b["MODEL"].pop("DEVICE")) == ("tpu", "cuda")
    assert a == b
    assert isinstance(tc, CfgNode) and isinstance(tc.MODEL.RESNETS, CfgNode)


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, ROOT))
def test_reader_equals_pyyaml_on_the_files(path):
    with open(path) as f:
        text = f.read()
    assert yaml_subset.safe_load(text) == yaml.safe_load(text)


@pytest.mark.parametrize("value", CLI_VALUES)
def test_reader_equals_pyyaml_on_override_values(value):
    got, want = yaml_subset.safe_load(value), yaml.safe_load(value)
    assert got == want and type(got) is type(want), (got, want)


def test_reader_takes_nan_and_multiline_flow_sequences():
    assert math.isnan(yaml_subset.safe_load(".nan"))
    text = "A:\n  B: [[1, 2],\n      [3, 4]]  # two lines\n  C: 'x # not a comment'\n"
    assert yaml_subset.safe_load(text) == yaml.safe_load(text) == {
        "A": {"B": [[1, 2], [3, 4]], "C": "x # not a comment"}}


@pytest.mark.parametrize("text,line", [
    ("A:\n  - 1\n  - 2\n", 2),            # block sequence
    ("A: {b: 1}\n", 1),                    # flow mapping
    ("A: &x 1\nB: *x\n", 1),               # anchor
    ("A: !!int 3\n", 1),                   # tag
    ("A: 012\n", 1),                       # octal (PyYAML: 10)
    ("A:\n  B: 0x1F\n", 2),                # hex
    ("A: 1:30\n", 1),                      # sexagesimal
    ("A:\n\tB: 1\n", 2),                   # tab
    ("A: |\n  text\n", 1),                 # block scalar
    ("---\nA: 1\n", 1),                    # document marker
    ("A:\n  B: [1, 2\nC: 3\n", 3),         # unclosed sequence, found on the next line
    ("A: 1\n  B: 2\n", 2),                 # stray indentation
    ("ON: 1\n", 1),                        # a key PyYAML reads as a boolean
])
def test_reader_raises_outside_the_subset_naming_the_line(text, line):
    with pytest.raises(yaml_subset.YAMLSubsetError, match=f"line {line}:"):
        yaml_subset.safe_load(text)


def test_merge_from_file_names_the_file_on_error(tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text("MODEL:\n  WEIGHTS: 0x10\n")
    with pytest.raises(yaml_subset.YAMLSubsetError, match="bad.yaml: line 2"):
        get_cfg().merge_from_file(str(p))


@pytest.mark.parametrize("path", YAMLS[:1] + YAMLS[-2:], ids=lambda p: os.path.basename(p))
def test_dump_reads_back_in_both_readers(path):
    """``dump`` writes the subset: PyYAML and the port's reader read it
    back to the tree (tuples as lists)."""
    _, tc = _both(path)
    text = tc.dump()

    def lists(node):
        if isinstance(node, dict):
            return {k: lists(v) for k, v in node.items()}
        return [lists(v) for v in node] if isinstance(node, (list, tuple)) else node

    assert yaml.safe_load(text) == yaml_subset.safe_load(text) == lists(plain(tc))


def test_merge_from_list_coerces_as_jax():
    opts = ["MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.25", "INPUT.PAD_SHAPE", "[640, 800]",
            "MODEL.RESNETS.DEPTH", "50", "MODEL.WEIGHTS", "", "SOLVER.STEPS", "[10, 20]",
            "DATASETS.TEST", "[FLIR_val]", "MODEL.BLUR_RGB", "True", "OUTPUT_DIR", "out/x",
            "MODEL.PIXEL_MEAN", "[1.5, 2, 3]", "SOLVER.BASE_LR", "1e-3"]
    jc, tc = jax_get_cfg(), get_cfg()
    jc.merge_from_list(opts)
    tc.merge_from_list(opts)
    a, b = plain(jc), plain(tc)
    a["MODEL"].pop("DEVICE"), b["MODEL"].pop("DEVICE")
    assert a == b
    assert tc.INPUT.PAD_SHAPE == (640, 800) and tc.SOLVER.BASE_LR == "1e-3"  # PyYAML's reading
    with pytest.raises(ValueError, match="pairs"):
        tc.merge_from_list(["MODEL.WEIGHTS"])


def test_legacy_version_1_config_migrates_as_jax(tmp_path):
    """A VERSION 1 file's renamed keys land where JAX puts them."""
    p = tmp_path / "legacy.yaml"
    p.write_text("MODEL:\n  WEIGHT: 'w.pkl'\n  ROI_HEADS:\n    SCORE_THRESH: 0.3\n"
                 "  RPN:\n    ANCHOR_SIZES: [[16], [32]]\nTEST:\n  DETECTIONS_PER_IMG: 7\n")
    jc, tc = _both(str(p))
    a, b = plain(jc), plain(tc)
    a["MODEL"].pop("DEVICE"), b["MODEL"].pop("DEVICE")
    assert a == b
    assert tc.MODEL.WEIGHTS == "w.pkl" and tc.TEST.DETECTIONS_PER_IMAGE == 7


def test_freeze_and_clone():
    cfg = get_cfg()
    other = cfg.clone()
    cfg.freeze()
    with pytest.raises(AttributeError, match="frozen"):
        cfg.MODEL.WEIGHTS = "x"
    other.MODEL.WEIGHTS = "x"
    assert cfg.MODEL.WEIGHTS == "" and other.MODEL.WEIGHTS == "x"


# ---------------------------------------------------------------------------
# typed configs
# ---------------------------------------------------------------------------

# the implementation names: the JAX package's -> the port's
IMPLS = {"roi_align_impl": {"pallas": "kernel", "gather": "plain"},
         "stem_impl": {"pallas": "kernel", "wpair": "kernel", "pack24": "kernel", "direct": "plain"}}
# fields of the JAX configs the port has no counterpart for: implied by the
# anchors (rpn.num_anchors)
JAX_ONLY = {"num_anchors"}


def _compare_fields(jax_obj, port_obj, where=""):
    a, b = dataclasses.asdict(jax_obj), dataclasses.asdict(port_obj)
    assert set(b) <= set(a) and set(a) - set(b) <= JAX_ONLY, (where, set(a) ^ set(b))
    for k in b:
        if isinstance(b[k], dict):
            _compare_fields(getattr(jax_obj, k), getattr(port_obj, k), where + k + ".")
        elif k in IMPLS:
            assert IMPLS[k][a[k]] == b[k], (where + k, a[k], b[k])
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k]), (where + k, a[k], b[k])


@pytest.mark.parametrize("path", YAMLS, ids=lambda p: os.path.relpath(p, ROOT))
def test_typed_configs_agree_field_by_field(path):
    jc, tc = _both(path)
    _compare_fields(jax_model_config_from_cfg(jc), model_config_from_cfg(tc))
    _compare_fields(jax_mapper_config_from_cfg(jc), mapper_config_from_cfg(tc))
    _compare_fields(jax_solver_config_from_cfg(jc), solver_config_from_cfg(tc))


@pytest.mark.parametrize("key,value", [("ROI_ALIGN_IMPL", "gather"), ("STEM_IMPL", "wpair"),
                                       ("STEM_IMPL", "pack24"), ("STEM_IMPL", "direct")])
def test_implementation_names_map(key, value):
    jc, tc = jax_get_cfg(), get_cfg()
    for c in (jc, tc):
        c.MODEL[key] = value
    _compare_fields(jax_model_config_from_cfg(jc), model_config_from_cfg(tc))


@pytest.mark.parametrize("key", ["ROI_ALIGN_IMPL", "STEM_IMPL"])
def test_unknown_implementation_name_raises(key):
    cfg = get_cfg()
    cfg.MODEL[key] = "triton"
    with pytest.raises(ValueError, match=key):
        model_config_from_cfg(cfg)


def test_remat_backbone_is_accepted():
    """``MODEL.REMAT_BACKBONE`` sets ``remat_backbone`` and nothing else."""
    cfg = get_cfg()
    cfg.MODEL.REMAT_BACKBONE = True
    got = model_config_from_cfg(cfg)
    assert got.remat_backbone is True and not model_config_from_cfg(get_cfg()).remat_backbone
    assert got == model_config_from_cfg(get_cfg()).replace(remat_backbone=True)
