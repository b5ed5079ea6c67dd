"""Hot-path audits of the port (the JAX package's ``analysis/``).

SPT's value is what the hot path does *not* do: sparse MHA never stores
the large attention weights, the routed FFN never builds the dense
(B, G, C, d) dispatch buffer at decode, the serving loop never syncs per
token.  Parity tests cannot see those properties — a refactor that
resurrects a dispatch buffer, repeats the GQA cache, adds an ``.item()``
inside the decode chunk, copies the KV cache each step or raises a
kernel's shared memory past Hopper's block keeps every test green while
the claims quietly evaporate.  This package checks them, on the CPU by
default and on the card with ``--device cuda``:

  * ``op_audit``    — each hot entrypoint runs under a dispatch mode:
    dispatch-buffer and cache-repeat shapes, host reads, kernels reached
    per switch state (JAX: ``jaxpr_audit``);
  * ``kernel_audit`` — each CUDA kernel's registers, shared memory and
    spills against Hopper's limits, the wrappers' contracts at every
    registry config's shapes, f32 accumulators (JAX: ``pallas_audit``);
  * ``trace_guard`` — the engine's host syncs per scheduling iteration
    and rebuilds in the serving loop;
  * ``lint``         — stdlib-``ast`` rules over ``src/repro_torch``;
  * ``liveness``     — peak live bytes, waterfalls and top contributors;
  * ``donation``     — caches, pools and slot state updated in place;
  * ``baselines``    — the memory signatures ratcheted against
    ``scripts/torch_analysis_baselines.json``.

CLI: ``python -m repro_torch.analysis`` (or ``scripts/torch_analyze.sh``)
runs every registered audit and exits nonzero on a violation.  Rules
register via ``registry.audit``; hot entrypoints via
``op_audit.hot_entrypoint``.  ``JAX_RULES`` maps every rule id of the
JAX package to its port rule, or to the reason it has none.
"""
from repro_torch.analysis.registry import AUDITS, Violation, audit, run_audits

# Every rule id of the JAX package's analysis/: its port rule, or why
# there is none (a string that does not name a port rule).
JAX_RULES = {
    "jaxpr.dispatch-buffer": "ops.dispatch-buffer",
    "jaxpr.cache-repeat": "ops.cache-repeat",
    "jaxpr.paged-gather": "ops.paged-gather",
    "jaxpr.intermediate-budget": "ops.intermediate-budget",
    "jaxpr.forbidden-primitive": "ops.host-sync",
    "jaxpr.accum-dtype": "kernel.accum-dtype",
    "jaxpr.kernel-missing": "ops.kernel-missing",
    "jaxpr.kernel-present": "ops.kernel-present",
    "jaxpr.telemetry-cost": "ops.telemetry-cost",
    "pallas.vmem-budget": "kernel.smem",
    "pallas.tile-divisibility": "kernel.contract",
    "pallas.scalar-prefetch": "JAX only: a CUDA kernel takes its page "
                              "table or plan as a plain pointer; there is "
                              "no scalar-prefetch operand to count",
    "pallas.no-kernel": "kernel.no-kernel",
    "trace.retrace": "trace.host-sync",
    "trace.per-iteration-jit": "trace.rebuild",
    "lint.jnp-repeat": "lint.cache-repeat",
    "lint.host-sync": "lint.host-sync",
    "lint.interpret-default": "lint.kernel-wrapper",
    "lint.dispatch-routing": "lint.dispatch-routing",
    "lint.paged-gather": "lint.paged-gather",
    "liveness.trace-failure": "liveness.trace-failure",
    "liveness.empty": "liveness.empty",
    "liveness.donation-unused": "liveness.inplace-unused",
    "donation.missing": "donation.grown",
    "donation.cannot-alias": "donation.copied",
    "donation.jit-site": "JAX only: the port has no jit sites; the engine "
                         "writes its caches in place (donation.copied)",
    "memory.regression": "memory.regression",
    "memory.stale-baseline": "memory.stale-baseline",
    "memory.signature-drift": "memory.signature-drift",
    "memory.baseline-missing": "memory.baseline-missing",
}

__all__ = ["AUDITS", "JAX_RULES", "Violation", "audit", "run_audits"]
