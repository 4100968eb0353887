"""``proben_tpu_torch`` and ``chip_smoke`` stand alone: importing them loads
neither JAX nor any module of ``proben_tpu`` (nor cv2, PyYAML or Pillow, which
the card's machine need not have), no source imports them outside the
CPU-only branches, and the entry points refuse to run on the CPU unless
asked to."""

import ast
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch
from torch_cores import share_cores  # noqa: F401  (autouse: PyTorch's share of the cores)

ROOT = Path(__file__).resolve().parent.parent


def test_imports_load_no_jax_and_no_proben_tpu():
    code = textwrap.dedent(
        """
        import sys

        def foreign():
            return sorted(m for m in sys.modules
                          if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                          or m.startswith("jaxlib.") or m == "proben_tpu"
                          or m.startswith("proben_tpu."))

        before = set(foreign())
        import proben_tpu_torch
        import proben_tpu_torch.checkpoint
        import proben_tpu_torch.engine
        import proben_tpu_torch.engine.train
        import proben_tpu_torch.fusion
        import proben_tpu_torch.fusion.proben_numpy
        import proben_tpu_torch.fusion.proben_torch
        import proben_tpu_torch.kernel_ab
        import proben_tpu_torch.kernel_probe
        import proben_tpu_torch.models
        import proben_tpu_torch.models.gaussian_blur
        import proben_tpu_torch.ops.roi_align_cuda
        import proben_tpu_torch.ops.stem_cuda
        import proben_tpu_torch.solver
        import proben_tpu_torch.structures
        import proben_tpu_torch.apps.flir
        import proben_tpu_torch.apps.kaist
        import proben_tpu_torch.apps.train_net
        import proben_tpu_torch.apps.plain_train_net
        import proben_tpu_torch.apps.benchmark
        import proben_tpu_torch.apps.visualize_data
        import proben_tpu_torch.apps.visualize_json_results
        import proben_tpu_torch.apps.convert_torchvision
        import proben_tpu_torch.checkpoint.ckpt
        import proben_tpu_torch.checkpoint.paths
        import proben_tpu_torch.checkpoint.torch_import
        import proben_tpu_torch.config
        import proben_tpu_torch.data
        import proben_tpu_torch.data.samplers
        import proben_tpu_torch.data.transforms
        import proben_tpu_torch.engine.defaults
        import proben_tpu_torch.engine.hooks
        import proben_tpu_torch.evaluation
        import proben_tpu_torch.data.builtin
        import proben_tpu_torch.data.cityscapes
        import proben_tpu_torch.data.lvis
        import proben_tpu_torch.data.pascal_voc
        import proben_tpu_torch.evaluation.build
        import proben_tpu_torch.evaluation.cityscapes
        import proben_tpu_torch.evaluation.kaist
        import proben_tpu_torch.evaluation.lvis
        import proben_tpu_torch.evaluation.panoptic
        import proben_tpu_torch.evaluation.pascal_voc
        import proben_tpu_torch.evaluation.rle
        import proben_tpu_torch.evaluation.sem_seg
        import proben_tpu_torch.evaluation.testing
        import proben_tpu_torch.models.batch_norm
        import proben_tpu_torch.models.layers
        import proben_tpu_torch.native
        import proben_tpu_torch.utils.events
        import proben_tpu_torch.utils.logger
        import proben_tpu_torch.utils.opt
        import proben_tpu_torch.structures.keypoints
        import proben_tpu_torch.structures.masks
        import proben_tpu_torch.structures.rotated_boxes
        import proben_tpu_torch.utils
        import proben_tpu_torch.utils.analysis
        import proben_tpu_torch.utils.env
        import proben_tpu_torch.utils.memory
        import proben_tpu_torch.utils.serialize
        import proben_tpu_torch.utils.video_visualizer
        import proben_tpu_torch.utils.visualizer
        import proben_tpu_torch.export
        import proben_tpu_torch.export.api
        import proben_tpu_torch.model_zoo
        import proben_tpu_torch.parallel
        import proben_tpu_torch.parallel.mesh
        import chip_smoke
        print(sorted(set(foreign()) - before))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_imports_load_no_cv2_yaml_or_pil():
    """The runtime slice (config, data, evaluation, native IO, checkpoints,
    the FLIR and KAIST apps, the trainer, its hooks and event writers,
    ``train_net`` and the other commands of ``apps/``), the model, ops and training modules, ``export``,
    ``model_zoo`` and ``parallel`` load none of cv2, PyYAML or Pillow: the
    card's machine may lack them."""
    code = textwrap.dedent(
        """
        import sys
        import proben_tpu_torch.apps.flir
        import proben_tpu_torch.apps.kaist
        import proben_tpu_torch.apps.train_net
        import proben_tpu_torch.apps.plain_train_net
        import proben_tpu_torch.apps.benchmark
        import proben_tpu_torch.apps.visualize_data
        import proben_tpu_torch.apps.visualize_json_results
        import proben_tpu_torch.apps.convert_torchvision
        import proben_tpu_torch.checkpoint
        import proben_tpu_torch.config
        import proben_tpu_torch.data
        import proben_tpu_torch.data.samplers
        import proben_tpu_torch.data.transforms
        import proben_tpu_torch.engine
        import proben_tpu_torch.engine.train
        import proben_tpu_torch.evaluation
        import proben_tpu_torch.models.batch_norm
        import proben_tpu_torch.utils.events
        import proben_tpu_torch.models
        import proben_tpu_torch.native
        import proben_tpu_torch.ops.roi_align_cuda
        import proben_tpu_torch.ops.stem_cuda
        import proben_tpu_torch.structures.keypoints
        import proben_tpu_torch.structures.masks
        import proben_tpu_torch.structures.rotated_boxes
        import proben_tpu_torch.utils
        import proben_tpu_torch.utils.memory
        import proben_tpu_torch.utils.serialize
        import proben_tpu_torch.utils.video_visualizer
        import proben_tpu_torch.export
        import proben_tpu_torch.model_zoo
        import proben_tpu_torch.parallel
        import chip_smoke
        print(sorted(m for m in sys.modules
                     if m.split(".")[0] in ("cv2", "yaml", "PIL", "orbax", "tensorstore")))
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# cv2 only inside the CPU branches that read and resize with it, as the JAX
# package does, and inside the host decode of a file that is not a JPEG
# (``native/io.py::decode_host``, the CPU path's ``cv2.imread``); Pillow only
# where the JAX package draws polygons and writes Cityscapes' mask PNGs with
# it; matplotlib only where the PR-curve plot is asked for; cv2 where the JAX
# package rasterizes polygons and draws (``PolygonMasks.rasterize``, the
# visualizers, and ``apps/visualize_json_results.py``'s ``main``, which reads
# and writes its images with cv2 as the JAX tool does)
ALLOWED_IMPORTS = {
    ("proben_tpu_torch/apps/visualize_json_results.py", "cv2"),
    ("proben_tpu_torch/data/detection_utils.py", "cv2"),
    ("proben_tpu_torch/data/transforms.py", "cv2"),
    ("proben_tpu_torch/evaluation/build.py", "PIL"),
    ("proben_tpu_torch/evaluation/cityscapes.py", "PIL"),
    ("proben_tpu_torch/evaluation/flir.py", "matplotlib"),
    ("proben_tpu_torch/native/io.py", "cv2"),
    ("proben_tpu_torch/structures/masks.py", "cv2"),
    ("proben_tpu_torch/utils/visualizer.py", "cv2"),
}


def test_sources_import_no_jax_proben_tpu_cv2_yaml_or_pil():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|proben_tpu\b|cv2|yaml|PIL|matplotlib)")
    found = set()
    for path in sorted(ROOT.glob("proben_tpu_torch/**/*.py")) + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            m = pattern.match(line)
            if m:
                found.add((str(path.relative_to(ROOT)), m.group(1)))
    assert found == ALLOWED_IMPORTS, found ^ ALLOWED_IMPORTS


def test_kaist_app_imports_cv2_only_in_its_cpu_reader():
    """The KAIST app reads its frames through ``DatasetMapper``, so
    ``apps/kaist.py`` imports no cv2 at all; the CPU reader it reaches,
    ``data/detection_utils.py``, imports cv2 in ``_read_image_cpu`` (the
    CPU branch of ``read_image``) and nowhere else."""
    def cv2_imports(rel):
        tree = ast.parse((ROOT / rel).read_text())
        owners = [fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
                  for node in ast.walk(fn)
                  if isinstance(node, ast.Import) and any(a.name == "cv2" for a in node.names)]
        top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))
               and "cv2" in [a.name for a in node.names] + [getattr(node, "module", None)]]
        return owners, top

    assert cv2_imports("proben_tpu_torch/apps/kaist.py") == ([], [])
    assert cv2_imports("proben_tpu_torch/data/detection_utils.py") == (["_read_image_cpu"], [])


def test_datasets_import_cv2_and_pil_only_inside_their_functions():
    """The other datasets' slice adds exactly three such imports, each
    inside one function and none at module level: cv2 in
    ``native/io.py::decode_host`` (a file that is not a JPEG, read as the
    CPU path reads it), Pillow in ``evaluation/build.py::_rasterize_polygons``
    and in ``evaluation/cityscapes.py``'s ``process`` (as in the JAX
    package). The loaders and the other evaluators import neither."""
    def owners(rel, module):
        tree = ast.parse((ROOT / rel).read_text())

        def imports(node):
            return (isinstance(node, ast.Import) and any(a.name.split(".")[0] == module for a in node.names)) \
                or (isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == module)

        assert not [node for node in tree.body if imports(node)], rel
        return sorted({fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
                       for node in ast.walk(fn) if imports(node)})

    assert owners("proben_tpu_torch/native/io.py", "cv2") == ["decode_host"]
    assert owners("proben_tpu_torch/native/io.py", "PIL") == []
    assert owners("proben_tpu_torch/evaluation/build.py", "PIL") == ["_rasterize_polygons"]
    assert owners("proben_tpu_torch/evaluation/cityscapes.py", "PIL") == ["process"]
    for rel in ("data/builtin.py", "data/cityscapes.py", "data/coco.py", "data/lvis.py", "data/pascal_voc.py",
                "evaluation/lvis.py", "evaluation/panoptic.py", "evaluation/pascal_voc.py", "evaluation/rle.py",
                "evaluation/sem_seg.py", "evaluation/cocoeval.py"):
        assert owners(f"proben_tpu_torch/{rel}", "cv2") == owners(f"proben_tpu_torch/{rel}", "PIL") == [], rel


def test_training_modules_import_cv2_only_in_the_cpu_resize():
    """The training slice keeps cv2 where the test path had it: in
    ``data/transforms.py`` only inside ``resize_image`` (the CPU resize the
    JAX package does with cv2), and not at all in the mapper, the loader,
    the trainer, its hooks and events, or the training apps."""
    def cv2_owners(rel):
        tree = ast.parse((ROOT / rel).read_text())
        top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))
               and "cv2" in [a.name for a in node.names] + [getattr(node, "module", None)]]
        assert not top, rel
        return sorted({fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
                       for node in ast.walk(fn)
                       if isinstance(node, ast.Import) and any(a.name == "cv2" for a in node.names)})

    assert cv2_owners("proben_tpu_torch/data/transforms.py") == ["resize_image"]
    for rel in ("data/dataset_mapper.py", "data/loader.py", "data/samplers.py", "engine/defaults.py",
                "engine/hooks.py", "utils/events.py", "models/batch_norm.py", "apps/flir.py",
                "apps/kaist.py", "apps/train_net.py"):
        assert cv2_owners(f"proben_tpu_torch/{rel}") == [], rel


def _import_owners(rel, module):
    """The functions of ``rel`` that import ``module``; none at module level."""
    tree = ast.parse((ROOT / rel).read_text())

    def imports(node):
        return (isinstance(node, ast.Import) and any(a.name.split(".")[0] == module for a in node.names)) \
            or (isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] == module)

    assert not [node for node in tree.body if imports(node)], rel
    return sorted({fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
                   for node in ast.walk(fn) if imports(node)})


def test_structures_and_utils_import_cv2_only_where_they_draw():
    """cv2 only inside ``PolygonMasks.rasterize`` and the visualizer's
    ``__init__`` (as in the JAX package); the rest of ``structures``,
    ``utils`` and the draw command (``apps/flir.py``) import none."""
    assert _import_owners("proben_tpu_torch/structures/masks.py", "cv2") == ["rasterize"]
    assert _import_owners("proben_tpu_torch/utils/visualizer.py", "cv2") == ["__init__"]
    for rel in ("structures/boxes.py", "structures/keypoints.py", "structures/rotated_boxes.py",
                "utils/analysis.py", "utils/env.py", "utils/memory.py", "utils/serialize.py",
                "utils/video_visualizer.py", "apps/flir.py"):
        assert _import_owners(f"proben_tpu_torch/{rel}", "cv2") == [], rel


def test_tool_commands_import_cv2_only_in_the_json_visualizers_main():
    """The five commands of ``tools/`` that the port carries import no cv2
    at module level: ``visualize_json_results`` imports it in ``main``
    (as the JAX tool does), the others not at all (``visualize_data``
    draws through ``Visualizer`` and reads through ``read_image``)."""
    assert _import_owners("proben_tpu_torch/apps/visualize_json_results.py", "cv2") == ["main"]
    for name in ("plain_train_net", "benchmark", "visualize_data", "convert_torchvision"):
        assert _import_owners(f"proben_tpu_torch/apps/{name}.py", "cv2") == [], name


def test_tool_commands_raise_without_cuda(monkeypatch, tmp_path):
    """``plain_train_net``, ``benchmark``, the two visualizers and the
    converter default to the card and raise without one, before touching
    any data or file."""
    from proben_tpu_torch.apps import (benchmark, convert_torchvision, plain_train_net, visualize_data,
                                       visualize_json_results)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [(plain_train_net.main, ["OUTPUT_DIR", str(tmp_path / "plain")]),
             (benchmark.main, ["--task", "eval"]),
             (visualize_data.main, ["--dataset", "absent", "--output-dir", str(tmp_path / "vis")]),
             (visualize_json_results.main, ["--input", str(tmp_path / "absent.json"), "--output",
                                            str(tmp_path / "json"), "--dataset", "absent"]),
             (convert_torchvision.main, [str(tmp_path / "absent.pth"), str(tmp_path / "out.pkl")])]
    for main, argv in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            main(argv)
    assert sorted(os.listdir(tmp_path)) == []


def test_no_orbax_in_the_package_and_no_jax_package_in_the_converter():
    """The card's machine has no orbax or tensorstore: no module of the
    package imports them (the converter does, outside it). The converter
    imports nothing of ``proben_tpu``: it reads orbax directories itself and
    maps them with the port's own code."""
    pattern = re.compile(r"^\s*(?:import|from)\s+(orbax|tensorstore)\b", re.M)
    for path in sorted(ROOT.glob("proben_tpu_torch/**/*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
    tree = ast.parse((ROOT / "tools" / "orbax_to_torch.py").read_text())
    modules = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    modules |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert "orbax.checkpoint" in modules and "proben_tpu_torch.checkpoint" in modules
    assert not [m for m in modules if m.split(".")[0] in ("proben_tpu", "jax", "jaxlib")], modules


def test_trainer_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """``DefaultTrainer``, the training mapper, ``train_flir`` and
    ``train_net`` default to the card and raise without one, before
    touching any data."""
    from proben_tpu_torch.apps import flir, train_net
    from proben_tpu_torch.config import get_cfg
    from proben_tpu_torch.data import DatasetMapper, MapperConfig
    from proben_tpu_torch.engine import DefaultTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_cfg()
    cfg.OUTPUT_DIR = str(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        DefaultTrainer(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        DatasetMapper(MapperConfig(), is_train=True)
    (tmp_path / flir.TRAIN_JSON_NAME).write_text('{"images": [], "annotations": [], "categories": []}')
    (tmp_path / flir.VAL_JSON_NAME).write_text('{"images": [], "annotations": [], "categories": []}')
    with pytest.raises(RuntimeError, match="cuda"):
        flir.train_flir("thermal_only", str(tmp_path), str(tmp_path / "out"), max_iter=1)
    with pytest.raises(RuntimeError, match="cuda"):
        train_net.main(["OUTPUT_DIR", str(tmp_path / "net")])


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from proben_tpu_torch.engine import Predictor, make_train_step
    from proben_tpu_torch.models import build_config, build_model
    from proben_tpu_torch.solver import SolverConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = build_config(depth=50)
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        Predictor(model, cfg)
    assert next(model.parameters()).device.type == "cpu"
    # training runs where the model lives: its state's generator is on the CPU
    init_state, _ = make_train_step(cfg, SolverConfig())
    assert init_state(model, 0).generator.device.type == "cpu"


def test_fused_entry_points_raise_without_cuda(monkeypatch):
    """Middle (BGRTTT) and early (BGRT) fusion models, their predictors and
    their training state follow the same device rule."""
    from proben_tpu_torch.engine import Predictor, make_train_step, trainable_mask
    from proben_tpu_torch.models import build_config, build_model
    from proben_tpu_torch.solver import SolverConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fmt in ("BGRTTT", "BGRT"):
        cfg = build_config(depth=50, input_format=fmt, freeze_at=3)
        with pytest.raises(RuntimeError, match="cuda"):
            build_model(cfg)
        model = build_model(cfg, device="cpu")
        with pytest.raises(RuntimeError, match="cuda"):
            Predictor(model, cfg)
        init_state, _ = make_train_step(cfg, SolverConfig(), trainable_mask(model, cfg.freeze_at))
        assert init_state(model, 0).generator.device.type == "cpu"


def test_chip_smoke_fails_without_cuda(tmp_path):
    """Without a card (or without the package beside it) the smoke script
    exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, alone)):
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                             text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
