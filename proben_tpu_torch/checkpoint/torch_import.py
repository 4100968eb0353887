"""Import detectron2/PyTorch checkpoints into parameter pytrees (counterpart of
``proben_tpu/checkpoint/torch_import.py``; the reference's weight sources,
``checkpoint/detection_checkpoint.py`` and ``c2_model_loading.py``):

  * ``.pth`` torch state_dicts (the demos' raw ``torch.save(state_dict)``
    loops, ``demo_train_FLIR.py:113``) and ``{"model": state_dict}`` wrappers;
  * detectron2-format ``.pkl`` zoo files ({"model": {key: ndarray}});
  * caffe2-format ImageNet ``.pkl`` backbones (R-50/R-101: ``conv1_w``,
    ``res2_0_branch2a_w``, BN ``_bn_s``/``_bn_b`` or ``res_conv1_bn_s`` style
    keys) via the standard c2->d2 renaming.

The result is the numpy pytree in ``proben_tpu``'s layout, which
``models.build_model(cfg, params=...)`` takes:

  * conv OIHW -> HWIO; linear (out, in) -> (in, out);
  * BatchNorm (weight, bias, running_mean, running_var) folded into the
    FrozenBN (scale, bias) affine (``models.layers.fold_batchnorm``);
  * box-head fc1 input permuted once, from torch's NCHW flatten order
    (c*49+y*7+x) to the (P, P, C) order the port pools in (y*7C+x*C+c).

float64 arrays become float32 and every other dtype is kept, as
``jnp.asarray`` does in the JAX package, so both give equal trees.
"""

from __future__ import annotations

import pickle
from typing import Dict, Optional

import numpy as np
import torch

from ..models.layers import fold_batchnorm
from .paths import resolve_checkpoint_path


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth (torch) or .pkl (pickle of numpy) checkpoint into a flat
    {key: numpy array} dict; strips the 'model' and 'module.' wrappers.
    Accepts ``detectron2://``/``catalog://``/http URLs (``paths.py``).
    Unpickles the file: load only files from a source you trust."""
    path = resolve_checkpoint_path(path)
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, dict) and "model" in data and isinstance(data["model"], dict):
        data = data["model"]
    out = {}
    for k, v in data.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            out[k] = v
    return out


def _is_caffe2_backbone(sd: Dict[str, np.ndarray]) -> bool:
    return any(k.startswith("res") and "_branch" in k for k in sd) or "conv1_w" in sd


def convert_caffe2_names(sd: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """c2 ImageNet backbone names -> d2 names (subset of the reference's
    ``c2_model_loading.py:68-211`` heuristic, specialized to ResNets)."""
    out = {}
    branch_to_conv = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3",
                      "branch1": "shortcut"}
    for k, v in sd.items():
        nk = None
        if k == "conv1_w":
            nk = "backbone.bottom_up.stem.conv1.weight"
        elif k == "conv1_b":
            continue  # d2 stems have no conv bias (folded into BN)
        elif k.startswith("res_conv1_bn_") or k.startswith("conv1_bn_"):
            part = {"s": "weight", "b": "bias"}.get(k.rsplit("_", 1)[1])
            if part:
                nk = f"backbone.bottom_up.stem.conv1.norm.{part}"
        elif k.startswith("res") and "_branch" in k:
            # e.g. res2_0_branch2a_w | res2_0_branch2a_bn_s
            head, tail = k.split("_branch")
            stage, block = head.split("_")
            branch_parts = tail.split("_")
            conv = branch_to_conv["branch" + branch_parts[0]]
            rest = "_".join(branch_parts[1:])
            base = f"backbone.bottom_up.{stage}.{block}.{conv}"
            if rest == "w":
                nk = f"{base}.weight"
            elif rest == "bn_s":
                nk = f"{base}.norm.weight"
            elif rest == "bn_b":
                nk = f"{base}.norm.bias"
            elif rest in ("bn_rm", "bn_riv"):
                nk = f"{base}.norm.{'running_mean' if rest == 'bn_rm' else 'running_var'}"
            elif rest == "b":
                continue
        if nk:
            out[nk] = v
    # caffe2 pkls often lack running stats (absorbed already): synthesize
    for k in list(out.keys()):
        if k.endswith(".norm.weight"):
            base = k[: -len(".weight")]
            out.setdefault(base + ".running_mean", np.zeros_like(out[k]))
            out.setdefault(base + ".running_var", np.ones_like(out[k]))
    return out


def _array(a) -> np.ndarray:
    a = np.asarray(a)
    return np.ascontiguousarray(a.astype(np.float32) if a.dtype == np.float64 else a)


def _conv(sd, key) -> Dict[str, np.ndarray]:
    p = {"w": _array(np.transpose(sd[f"{key}.weight"], (2, 3, 1, 0)))}
    if f"{key}.bias" in sd:
        p["b"] = _array(sd[f"{key}.bias"])
    return p


def _norm(sd, key) -> Dict[str, np.ndarray]:
    return fold_batchnorm(
        sd[f"{key}.weight"],
        sd[f"{key}.bias"],
        sd.get(f"{key}.running_mean", np.zeros_like(sd[f"{key}.weight"])),
        sd.get(f"{key}.running_var", np.ones_like(sd[f"{key}.weight"])),
    )


def _linear(sd, key, perm: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    w = sd[f"{key}.weight"].T  # (in, out)
    if perm is not None:
        w = w[perm]
    p = {"w": _array(w)}
    if f"{key}.bias" in sd:
        p["b"] = _array(sd[f"{key}.bias"])
    return p


def _import_resnet(sd, prefix: str, template: Dict) -> Dict:
    out = {
        "stem": {
            "conv1": _conv(sd, f"{prefix}.stem.conv1"),
            "norm1": _norm(sd, f"{prefix}.stem.conv1.norm"),
        }
    }
    for stage in ("res2", "res3", "res4", "res5"):
        blocks = []
        for b in range(len(template[stage])):
            base = f"{prefix}.{stage}.{b}"
            block = {
                "conv1": _conv(sd, f"{base}.conv1"),
                "norm1": _norm(sd, f"{base}.conv1.norm"),
                "conv2": _conv(sd, f"{base}.conv2"),
                "norm2": _norm(sd, f"{base}.conv2.norm"),
                "conv3": _conv(sd, f"{base}.conv3"),
                "norm3": _norm(sd, f"{base}.conv3.norm"),
            }
            if f"{base}.shortcut.weight" in sd:
                block["shortcut"] = _conv(sd, f"{base}.shortcut")
                block["shortcut_norm"] = _norm(sd, f"{base}.shortcut.norm")
            blocks.append(block)
        out[stage] = blocks
    return out


def _import_fpn(sd, prefix: str, template: Dict) -> Dict:
    n = len(template["lateral"])
    return {
        "lateral": [_conv(sd, f"{prefix}.fpn_lateral{i + 2}") for i in range(n)],
        "output": [_conv(sd, f"{prefix}.fpn_output{i + 2}") for i in range(n)],
    }


def fc1_nchw_to_nhwc_perm(in_dim: int, spatial: int = 7) -> np.ndarray:
    """Permutation p with w_nhwc[j] = w_nchw_T[p[j]] for the box head's first
    FC: torch row index c*S*S + y*S + x -> ours y*S*C + x*C + c."""
    c = in_dim // (spatial * spatial)
    return np.arange(in_dim, dtype=np.int64).reshape(c, spatial, spatial).transpose(1, 2, 0).reshape(-1)


def _check_shapes(out, template, strict: bool, path: str = "") -> None:
    """Walk ``out`` beside ``template`` (the same nesting of dicts and
    lists); under ``strict`` a leaf of another shape raises."""
    if isinstance(template, (dict, list, tuple)):
        is_dict = isinstance(template, dict)
        if type(out) is not type(template) or (
                sorted(out) != sorted(template) if is_dict else len(out) != len(template)):
            raise ValueError(f"structure mismatch at {path or 'the root'}: ckpt and model differ")
        for k, t in (template.items() if is_dict else enumerate(template)):
            _check_shapes(out[k], t, strict, f"{path}[{k!r}]")
    elif strict and np.shape(out) != np.shape(template):
        raise ValueError(f"shape mismatch at {path}: ckpt {np.shape(out)} vs model {np.shape(template)}")


def import_detectron2_checkpoint(
    path_or_sd,
    template_params: Dict,
    pooler_resolution: int = 7,
    strict: bool = True,
) -> Dict:
    """The numpy parameter pytree of a detectron2 checkpoint (a path or a
    flat state dict).

    ``template_params``: a pytree from ``init_rcnn`` (defines the structure:
    depth, fusion mode, variance head). Missing keys raise unless
    ``strict=False``; then the template's values are kept for that part,
    mirroring the reference checkpointer's skip."""
    sd = path_or_sd if isinstance(path_or_sd, dict) else load_state_dict(path_or_sd)
    if _is_caffe2_backbone(sd):
        sd = convert_caffe2_names(sd)
    # backbone-only checkpoints (e.g. tools/convert_torchvision.py output)
    # carry bare stem./resN. keys; the reference's matching_heuristics maps
    # them onto the model's backbone, as the prefix here does
    if any(k.startswith("stem.") for k in sd) and not any(k.startswith("backbone.") for k in sd):
        sd = {f"backbone.bottom_up.{k}": v for k, v in sd.items()}

    def attempt(fn, *args, fallback):
        try:
            return fn(*args)
        except KeyError:
            if strict:
                raise
            return fallback

    out: Dict = {}
    out["backbone"] = attempt(_import_resnet, sd, "backbone.bottom_up", template_params["backbone"],
                              fallback=template_params["backbone"])
    if "fpn" in template_params:
        out["fpn"] = attempt(_import_fpn, sd, "backbone", template_params["fpn"],
                             fallback=template_params["fpn"])
    if "backbone_2" in template_params:
        out["backbone_2"] = attempt(_import_resnet, sd, "backbone_2.bottom_up",
                                    template_params["backbone_2"], fallback=template_params["backbone_2"])
        out["fpn_2"] = attempt(_import_fpn, sd, "backbone_2", template_params["fpn_2"],
                               fallback=template_params["fpn_2"])

    if "rpn_head" in template_params:
        def rpn():
            return {
                "conv": _conv(sd, "proposal_generator.rpn_head.conv"),
                "objectness": _conv(sd, "proposal_generator.rpn_head.objectness_logits"),
                "deltas": _conv(sd, "proposal_generator.rpn_head.anchor_deltas"),
            }

        out["rpn_head"] = attempt(rpn, fallback=template_params["rpn_head"])

    if "roi" in template_params:
        def roi():
            fcs = []
            for i in range(len(template_params["roi"]["box_head"]["fcs"])):
                if i == 0:
                    in_dim = sd["roi_heads.box_head.fc1.weight"].shape[1]
                    perm = fc1_nchw_to_nhwc_perm(in_dim, pooler_resolution)
                    fcs.append(_linear(sd, "roi_heads.box_head.fc1", perm))
                else:
                    fcs.append(_linear(sd, f"roi_heads.box_head.fc{i + 1}"))
            output = {
                "cls_score": _linear(sd, "roi_heads.box_predictor.cls_score"),
                "bbox_pred": _linear(sd, "roi_heads.box_predictor.bbox_pred"),
            }
            if "var_pred" in template_params["roi"]["output"]:
                if "roi_heads.box_predictor.var_pred.weight" in sd:
                    output["var_pred"] = _linear(sd, "roi_heads.box_predictor.var_pred")
                else:
                    output["var_pred"] = template_params["roi"]["output"]["var_pred"]
            return {"box_head": {"fcs": fcs}, "output": output}

        out["roi"] = attempt(roi, fallback=template_params["roi"])

    _check_shapes(out, template_params, strict)
    return out
