"""Sharding planner: specs for params, optimizer state, batches, caches.

The port of ``repro.sharding.planner``, with the same strategy:
  * DP   — batch over ("pod", "data").
  * FSDP — parameters + optimizer state additionally sharded over "data"
           on a non-TP dimension (ZeRO-3 style; the model gathers a
           layer's FSDP axis at the layer's use).
  * TP   — head / FFN-hidden / expert / SSM-channel dims over "model".
  * Fallback — any dim not divisible by its mesh axis is replicated
           (e.g. Hymba's 25 heads): the planner never produces an invalid
           spec, it degrades per-tensor.

A spec is a :class:`Spec`: a tuple with one entry per tensor dim, each a
mesh-axis name, ``None`` or a tuple of names, canonicalized as JAX's
``PartitionSpec`` is (a one-name tuple is the name), so a spec compares
equal to the reference's as a tuple.  :func:`placements` turns a spec into
the DTensor ``Shard``/``Replicate`` list of a ``DeviceMesh``.

The planner reads only ``.shape`` (and tree paths), so meta or fake
tensors (``train/step.py::abstract_train_state``) plan a 236B config
without storage.
"""
from __future__ import annotations

import dataclasses
import re
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

if TYPE_CHECKING:   # the model stack imports this package
    from repro_torch.models.config import ModelConfig

# role -> which logical mesh resource it wants
_ROLE_TABLE: Dict[str, Tuple[Optional[str], ...]] = {
    # embeddings
    "embed": ("tp", "fsdp"),
    "lm_head": ("tp", "fsdp"),
    # GQA attention
    "wq": ("fsdp", "tp", None),
    "wk": ("fsdp", "tp", None),
    "wv": ("fsdp", "tp", None),
    "wo": ("tp", None, "fsdp"),
    # MLA (latent dims FSDP-sharded for storage; gathered at use)
    "w_dq": ("fsdp", "tp"),
    "w_uq": ("fsdp", "tp", None),
    "w_q": ("fsdp", "tp", None),       # MLA without query compression
    "w_dkv": ("fsdp", "tp"),
    "w_uk": ("fsdp", "tp", None),
    "w_uv": ("fsdp", "tp", None),
    # MLP
    "w_gate": ("fsdp", "tp"),
    "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    # MoE (keys prefixed with moe/ in the path get the expert variants)
    "moe/w_gate": ("tp", "fsdp", None),
    "moe/w_up": ("tp", "fsdp", None),
    "moe/w_down": ("tp", None, "fsdp"),
    # router is tiny (d x E): replicated over model
    "moe/router": ("fsdp", None),
    # Mamba
    "in_proj": ("fsdp", "tp"),
    "conv_w": (None, "tp"),
    "conv_b": ("tp",),
    "x_proj": ("tp", None),
    "dt_proj": (None, "tp"),
    "dt_bias": ("tp",),
    "A_log": ("tp", None),
    "D": ("tp",),
    "out_proj": ("tp", "fsdp"),
}


class Spec(tuple):
    """One entry per tensor dim: a mesh-axis name, None, or a tuple of
    names (a one-name tuple canonicalizes to the name, as in
    ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        def canon(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return e[0] if len(e) == 1 else (e or None)
            return e
        return super().__new__(cls, (canon(e) for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceGrid``, a ``DeviceMesh`` or a dict."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # torch DeviceMesh
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)                     # DeviceGrid


def placements(spec: Spec, mesh: Any) -> list:
    """The DTensor placements of `spec` on `mesh` (a ``DeviceMesh``): one
    ``Shard(dim)`` or ``Replicate()`` per mesh dimension.  A dim that
    several axes shard, such as ``("pod", "data")``, is split over them
    in mesh order, major first, as a PartitionSpec splits it.  An axis of
    size 1 gives ``Replicate()``: the same layout, and a redistribution
    to it never copies."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are "
                             f"not in the mesh's order {names}")
        for a in axes:
            if sizes[a] > 1:
                out[names.index(a)] = Shard(dim)
    return out


def _map_with_path(fn, tree, prefix: Tuple = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Resolved axis names + sizes for one mesh."""
    mesh_axes: Dict[str, int]            # name -> size
    dp_axes: Tuple[str, ...]             # batch axes, e.g. ("pod", "data")
    fsdp_axis: Optional[str] = "data"    # parameter-sharding axis
    tp_axis: str = "model"
    # serving (weight-stationary) mode: TP-sharded leaves drop their FSDP
    # axis; leaves with no TP shard stay FSDP'd
    serving: bool = False

    @classmethod
    def for_mesh(cls, mesh: Any, *, fsdp: bool = True) -> "Plan":
        axes = mesh_axes(mesh)
        dp = tuple(a for a in ("pod", "data") if a in axes)
        return cls(mesh_axes=axes, dp_axes=dp,
                   fsdp_axis="data" if fsdp and "data" in axes else None)

    @property
    def dp_size(self) -> int:
        n = 1
        for a in self.dp_axes:
            n *= self.mesh_axes[a]
        return n

    # -------------------------------------------------------------- params
    def _resolve(self, roles: Tuple[Optional[str], ...],
                 shape: Tuple[int, ...]) -> Spec:
        """Align roles to trailing dims; drop non-divisible assignments."""
        ndim = len(shape)
        full = (None,) * (ndim - len(roles)) + tuple(roles)
        spec = []
        for dim, role in zip(shape, full):
            axis = None
            if role == "tp":
                axis = self.tp_axis
            elif role == "fsdp":
                axis = self.fsdp_axis
            if axis is not None and dim % self.mesh_axes[axis] != 0:
                axis = None
            spec.append(axis)
        if self.serving and self.tp_axis in spec and self.fsdp_axis in spec:
            spec = [None if a == self.fsdp_axis else a for a in spec]
        return Spec(*spec)

    def param_specs(self, params: Any) -> Any:
        """Spec tree matching a params (or m/v) tree."""
        def leaf_spec(path, leaf):
            pstr = _path_str(path)
            name = pstr.rsplit("/", 1)[-1]
            if re.search(r"(ln|norm|scale)", name):
                return Spec()
            key = (f"moe/{name}" if "/moe/" in f"/{pstr}/"
                   and f"moe/{name}" in _ROLE_TABLE else name)
            # shared experts inside MoE use the plain MLP rules
            if "/shared/" in f"/{pstr}/":
                key = name
            roles = _ROLE_TABLE.get(key)
            if roles is None:
                return Spec()
            return self._resolve(roles, tuple(leaf.shape))

        return _map_with_path(leaf_spec, params)

    # -------------------------------------------------------------- batch
    def _dp(self, size: int):
        """Batch sharding: largest prefix of dp axes that divides size."""
        axes = []
        prod = 1
        for a in self.dp_axes:
            if size % (prod * self.mesh_axes[a]) == 0:
                axes.append(a)
                prod *= self.mesh_axes[a]
        return tuple(axes) if axes else None

    def batch_specs(self, batch: Any) -> Any:
        def spec(_, leaf):
            b = self._dp(leaf.shape[0])
            return Spec(b, *([None] * (len(leaf.shape) - 1)))
        return _map_with_path(spec, batch)

    # -------------------------------------------------------------- caches
    def cache_specs(self, cfg: ModelConfig, caches: Any) -> Any:
        """Decode-cache specs: batch over dp; heads over tp if divisible,
        otherwise the sequence dim over tp (flash-decode style)."""
        tp = self.mesh_axes[self.tp_axis]

        def leaf_spec(path, leaf):
            name = _path_str(path).rsplit("/", 1)[-1]
            shape = tuple(leaf.shape)  # leading dim is the stacked layer dim
            b = self._dp(shape[1])
            if name in ("k", "v", "xk", "xv"):
                _, _, S, kv, _ = shape
                if kv % tp == 0:
                    return Spec(None, b, None, self.tp_axis, None)
                if S % tp == 0:
                    return Spec(None, b, self.tp_axis, None, None)
                return Spec(None, b, None, None, None)
            if name == "ckv" or name == "k_rope":
                _, _, S, _ = shape
                if S % tp == 0:
                    return Spec(None, b, self.tp_axis, None)
                return Spec(None, b, None, None)
            if name == "conv":   # (L, B, dc-1, di)
                return Spec(None, b, None,
                            self.tp_axis if shape[3] % tp == 0 else None)
            if name == "h":      # (L, B, di, st)
                return Spec(None, b,
                            self.tp_axis if shape[2] % tp == 0 else None,
                            None)
            return Spec(*([None] * len(shape)))

        return _map_with_path(leaf_spec, caches)

    # -------------------------------------------------------------- acts
    def act_spec(self, sp: bool = False) -> Spec:
        """Residual-stream constraint (B, S, D). ``sp`` adds Megatron-style
        sequence sharding over the model axis."""
        return Spec(self.dp_axes if self.dp_axes else None,
                    self.tp_axis if sp else None, None)

    def logits_spec(self, batch_size: int = 0) -> Spec:
        b = self._dp(batch_size) if batch_size else (self.dp_axes or None)
        return Spec(b, None, self.tp_axis)
