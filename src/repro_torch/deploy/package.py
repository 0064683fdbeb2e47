"""One-shot model packing for the SNN serving runtime.

Port of ``repro.deploy.package``.  :func:`deploy` walks the model graph
once, quantizes + packs every post-stem conv/dense layer, folds the float
threshold into a per-channel int32 ``theta_q``, and keeps the float stem
and head, so the serving path never touches the quantizer.

Artifact (``save`` / ``load``): the JAX package's v2 ``.npz`` format,
read and written field for field, so either package loads the other's:

    __manifest__            JSON header: format version, serialized
                            SNNConfig, per-layer kind/bits/geometry,
                            per-fusion-group bundles (name, members,
                            bits, packed_bytes, smem_bytes)
    layer:<name>:data       packed int32 weight words
    layer:<name>:scale      float32 per-channel quantizer scales
    layer:<name>:theta      int32 per-channel folded thresholds
    param:<dotted.path>     float leaves (the stem and the readout head)

The groups section is informational: ``load`` (here and in ``repro``)
re-plans the groups from the cfg's ``fusion`` request.  The port writes
``smem_bytes`` (``kernels/smem.py``) where ``repro`` writes its own
``vmem_bytes``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Union

import numpy as np
import torch

from repro_torch.core.lif import LIFConfig
from repro_torch.core.snn_layers import (
    _fold_threshold_q,
    pack_conv_weights,
    pack_dense_weights,
)
from repro_torch.device import resolve_device
from repro_torch.graph import build_graph, group_smem_bytes
from repro_torch.graph.spec import Conv, Dense, get_path, set_path
from repro_torch.quant.formats import (
    PrecisionConfig,
    QuantizedConvTensor,
    QuantizedTensor,
)

PACKAGE_FORMAT_VERSION = 2
# v1 packages carry no "groups" section; both lower layer by layer.
COMPAT_FORMAT_VERSIONS = (1, 2)


@dataclasses.dataclass
class PackedLayer:
    """One deployed layer: packed integer weights + folded thresholds.

    kind:     "conv" (fused_conv rollout) or "dense" (fused_nce rollout).
    qt:       QuantizedConvTensor (conv) or QuantizedTensor (dense,
              (d_out, d_in) layout).
    theta_q:  (c_out,) int32 per-channel integer thresholds.
    stride:   conv stride (1 for dense).
    """

    kind: str
    qt: Union[QuantizedTensor, QuantizedConvTensor]
    theta_q: torch.Tensor
    stride: int = 1

    @property
    def geometry(self) -> Dict:
        """Static layer geometry recorded in the package manifest."""
        if self.kind == "conv":
            return {"kh": self.qt.kh, "kw": self.qt.kw,
                    "c_in": self.qt.c_in, "c_out": self.qt.c_out,
                    "c_in_pad": self.qt.c_in_pad, "stride": self.stride}
        d_out, d_in = self.qt.shape
        return {"d_in": d_in, "d_out": d_out,
                "group_size": self.qt.group_size}

    def to(self, device) -> "PackedLayer":
        return dataclasses.replace(self, qt=self.qt.to(device),
                                   theta_q=self.theta_q.to(device))

    def nbytes_packed(self) -> int:
        return self.qt.nbytes_packed() + self.theta_q.numel() * 4


def _tree_map(fn, tree):
    """``fn`` over the tensor leaves of a dict/list tree; other leaves (a
    ResNet block's int ``stride``) are kept as they are."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


@dataclasses.dataclass
class DeployedModel:
    """A fully packed SNN ready for the batched serve engine.

    cfg:           the SNNConfig the package was built for (int_path).
    float_params:  the float leaves the integer forward still needs
                   (stem conv and readout head).
    layers:        flat name -> PackedLayer for every fused-kernel layer.
    """

    cfg: "SNNConfig"  # noqa: F821
    float_params: Dict
    layers: Dict[str, PackedLayer]

    def to(self, device) -> "DeployedModel":
        device = resolve_device(device)
        return DeployedModel(
            cfg=self.cfg,
            float_params=_tree_map(lambda t: t.to(device), self.float_params),
            layers={n: lp.to(device) for n, lp in self.layers.items()})

    def apply(self, images: torch.Tensor) -> torch.Tensor:
        """Packed integer forward: (B, H, W, C) -> (B, n_classes)."""
        from repro_torch.models import snn_cnn

        return snn_cnn.apply(self.float_params, self.cfg, images,
                             package=self)

    def apply_with_rates(self, images: torch.Tensor):
        from repro_torch.models import snn_cnn

        return snn_cnn.apply_with_rates(self.float_params, self.cfg, images,
                                        package=self)

    def nbytes_packed(self) -> int:
        """Device bytes of all packed layers (weights + scales + thetas)."""
        return sum(lp.nbytes_packed() for lp in self.layers.values())

    def nbytes_dense_fp32(self) -> int:
        return sum(lp.qt.nbytes_dense_fp32() for lp in self.layers.values())

    def compression_ratio(self) -> float:
        return self.nbytes_dense_fp32() / max(self.nbytes_packed(), 1)

    def _group_manifest(self):
        """Per-fusion-group bundles for the v2 manifest: member order,
        datapath width, the members' packed bytes, and the shared memory
        the group's ``fused_group`` launch holds per block."""
        graph = build_graph(self.cfg)
        return [{
            "name": g.name,
            "members": list(g.members),
            "bits": self.cfg.precision.bits,
            "smem_bytes": int(group_smem_bytes(graph, g)),
            "packed_bytes": sum(self.layers[m].nbytes_packed()
                                for m in g.members if m in self.layers),
        } for g in graph.groups]

    def save(self, path: str) -> str:
        """Write the package as one flat npz (see module docstring)."""
        arrays: Dict[str, np.ndarray] = {}
        manifest = {
            "version": PACKAGE_FORMAT_VERSION,
            "cfg": dataclasses.asdict(self.cfg),
            "layers": {},
            "groups": self._group_manifest(),
            "float_params": [],
        }
        for name, lp in self.layers.items():
            manifest["layers"][name] = {
                "kind": lp.kind,
                "bits": lp.qt.bits,
                "shape": list(lp.qt.shape),
                "geometry": lp.geometry,
            }
            arrays[f"layer:{name}:data"] = lp.qt.data.cpu().numpy()
            arrays[f"layer:{name}:scale"] = lp.qt.scale.cpu().numpy()
            arrays[f"layer:{name}:theta"] = lp.theta_q.cpu().numpy()
        for pth, arr in _flatten_params(self.float_params):
            manifest["float_params"].append(pth)
            arrays[f"param:{pth}"] = arr.detach().cpu().numpy()
        arrays["__manifest__"] = np.array(json.dumps(manifest))
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        return path


def load(path: str, device="cuda") -> DeployedModel:
    """Read a package written by :meth:`DeployedModel.save` or by the JAX
    package's ``save`` onto ``device``.  Fusion groups come from
    re-planning the cfg's ``fusion`` request, as in ``repro``."""
    device = resolve_device(device)

    def tensor(arr):
        return torch.from_numpy(np.asarray(arr)).to(device)

    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["__manifest__"][()]))
        if manifest["version"] not in COMPAT_FORMAT_VERSIONS:
            raise ValueError(
                f"package format v{manifest['version']} is not one of "
                f"{COMPAT_FORMAT_VERSIONS}")
        cfg = _cfg_from_dict(manifest["cfg"])
        layers = {}
        for name, meta in manifest["layers"].items():
            data = tensor(z[f"layer:{name}:data"])
            scale = tensor(z[f"layer:{name}:scale"])
            theta = tensor(z[f"layer:{name}:theta"])
            geo = meta["geometry"]
            if meta["kind"] == "conv":
                qt = QuantizedConvTensor(
                    data=data, scale=scale, shape=tuple(meta["shape"]),
                    bits=meta["bits"], c_in_pad=geo["c_in_pad"])
                layers[name] = PackedLayer("conv", qt, theta,
                                           stride=geo["stride"])
            else:
                qt = QuantizedTensor(
                    data=data, scale=scale, zero=None,
                    shape=tuple(meta["shape"]), bits=meta["bits"],
                    group_size=geo["group_size"])
                layers[name] = PackedLayer("dense", qt, theta)
        float_params = _unflatten_params(
            {p: tensor(z[f"param:{p}"]) for p in manifest["float_params"]})
    return DeployedModel(cfg=cfg, float_params=float_params, layers=layers)


def deploy(params, cfg, device="cuda") -> DeployedModel:
    """Pack a float SNN checkpoint for integer deployment, in one pass over
    the model graph: every packable spec (post-stem convs, fc1) is
    quantized with its gain folded in, packed, and gets its per-channel
    integer threshold; the stem and head stay float.  ``params`` (torch
    tensors on any device) are moved to ``device`` first."""
    device = resolve_device(device)
    if not cfg.int_path:
        raise ValueError(
            "deploy() packs the integer datapath: cfg needs "
            "int_deploy=True and a quantized precision (bits in {2,4,8})")
    if not cfg.precision.symmetric:
        raise ValueError(
            "deploy(): the integer threshold fold assumes symmetric "
            "quantization (a zero point cannot fold into theta_q)")
    pc, lif = cfg.precision, cfg.lif
    params = _tree_map(lambda t: t.to(device), params)
    layers: Dict[str, PackedLayer] = {}
    float_params: Dict = {}
    for spec in build_graph(cfg).param_specs():
        p = get_path(params, spec.name)
        if isinstance(spec, Conv) and not spec.stem:
            qct = pack_conv_weights(p, pc)
            layers[spec.name] = PackedLayer(
                "conv", qct, _fold_threshold_q(qct.scale, lif),
                stride=spec.stride)
        elif isinstance(spec, Dense):
            qt = pack_dense_weights(p, pc)
            layers[spec.name] = PackedLayer(
                "dense", qt, _fold_threshold_q(qt.scale, lif))
        else:   # stem conv + readout head stay float
            set_path(float_params, spec.name, dict(p))
    return DeployedModel(cfg=cfg, float_params=float_params, layers=layers)


def deploy_config(model: str = "vgg9", bits: int = 4, smoke: bool = True,
                  fusion=()):
    """The int-deploy ``SNNConfig`` every serve entry point shares: the
    JAX package's reduced smoke geometry or the paper-size model.
    ``fusion`` is the multi-layer fusion request (``()`` / ``"auto"`` /
    explicit member tuples, see ``repro_torch.graph.fusion``)."""
    from repro_torch.models.snn_cnn import SNNConfig

    fusion = _normalize_fusion(fusion)
    pc = PrecisionConfig(bits=bits)
    if smoke:
        return SNNConfig(model=model, img_size=16, timesteps=3,
                         scale=0.15, n_classes=4, int_deploy=True,
                         precision=pc, fusion=fusion)
    return SNNConfig(model=model, int_deploy=True, precision=pc,
                     fusion=fusion)


# ---------------------------------------------------------------------------
# (de)serialization helpers
# ---------------------------------------------------------------------------

def _normalize_fusion(fusion):
    """Hashable form of a fusion request: JSON round-trips tuples as
    lists, and SNNConfig must stay hashable (it keys the graph cache)."""
    if isinstance(fusion, str) or not fusion:
        return fusion if fusion else ()
    return tuple(tuple(m) for m in fusion)


def _cfg_from_dict(d: Dict):
    from repro_torch.models.snn_cnn import SNNConfig

    d = dict(d)
    d["lif"] = LIFConfig(**d["lif"])
    d["precision"] = PrecisionConfig(**d["precision"])
    # absent in v1 manifests (pre-fusion packages lower layer by layer)
    d["fusion"] = _normalize_fusion(d.get("fusion", ()))
    return SNNConfig(**d)


def _flatten_params(tree, prefix: str = ""):
    """Yield (dotted path, tensor) for a nested dict/list float tree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten_params(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_params(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _unflatten_params(flat: Dict[str, torch.Tensor]):
    """Inverse of :func:`_flatten_params` (numeric components -> lists)."""
    root: Dict = {}
    for path, arr in flat.items():
        set_path(root, path, arr)
    return root
