"""Logical-axis -> mesh-axis rule tables (a copy of the JAX package's
``sharding/rules.py``).

The production mesh is (data, model) per pod, with a leading ``pod`` axis
in multi-pod mode used as extra data parallelism.  Divisibility is checked
where a rule is applied (``core/params.spec_tree``,
``sharding/context.spec_for``), so small models degrade to replication on
the axes that do not divide instead of failing.
"""
from __future__ import annotations

from typing import Dict

# Baseline (paper-faithful TP/DP) rule table.
RULES: Dict[str, object] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,              # sequence replicated by default (SP opts in)
    "seq_shard": "model",     # long-context KV/state sharding (decode)
    # Megatron-style sequence parallelism for the residual stream between
    # blocks (models/transformer.py gathers it at attention and the FFN)
    "seq_sp": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "act_ffn": "model",
    # MoE expert weights: ZeRO-3/FSDP-style, sharded over data AND model
    "expert_ffn": ("data", "model"),
    # dispatch-buffer capacity dim (routed FFN / MoE)
    "dispatch_c": "model",
    # params
    "vocab": "model",
    "group": None,            # routed-FFN block axis stays whole per block
    "expert": None,           # MoE experts: ffn dim sharded instead
    "lora_rank": None,
    "layer": None,
    "codebook": None,
    "codeword": None,
    "code_dim": None,
    "conv": None,
    "state": None,
    "lru": "model",
    "lru_blocks": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
}


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: extent} of a ``torch.distributed.device_mesh.DeviceMesh``
    (or any object with ``mesh_dim_names`` and a ``mesh`` array)."""
    return dict(zip(mesh.mesh_dim_names,
                    (int(s) for s in mesh.mesh.shape)))


def mesh_coords(mesh) -> Dict[str, int]:
    """{axis name: this rank's index along it} of a DeviceMesh."""
    return {n: int(mesh.get_local_rank(n)) for n in mesh.mesh_dim_names}


def rules_for_mesh(mesh) -> Dict[str, object]:
    """Attach mesh axis sizes (``__sizes__``), drop the axes the mesh does
    not have, and keep the mesh itself (``__mesh__``) for the explicit
    collective schedules (core/ffn_shmap.py, core/collectives.py)."""
    sizes = mesh_sizes(mesh)
    out: Dict[str, object] = {}
    for k, v in RULES.items():
        if v is None:
            out[k] = None
        else:
            flat = (v,) if isinstance(v, str) else tuple(v)
            kept = tuple(a for a in flat if a in sizes)
            out[k] = None if not kept else (kept[0] if len(kept) == 1
                                            else kept)
    out["__sizes__"] = sizes
    out["__mesh__"] = mesh
    return out
