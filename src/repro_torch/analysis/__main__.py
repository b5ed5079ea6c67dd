"""CLI: ``python -m repro_torch.analysis`` — run every registered audit,
print violations, exit nonzero if any fired.  ``--only ops,lint`` selects
audits; ``--list`` shows what is registered; ``--memory-report`` prints
the liveness waterfalls instead of auditing (``--out`` saves a copy);
``--device cuda`` runs the entrypoints, the trace guard and the kernel
audit on the card (the default is the CPU; the ``memory`` ratchet always
reads the CPU's signatures).  ``scripts/torch_analyze.sh`` wraps it.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import sys
import time
from typing import List, Optional

from repro_torch.analysis import registry
# importing the layers registers their audits
from repro_torch.analysis import op_audit       # noqa: F401
from repro_torch.analysis import kernel_audit   # noqa: F401
from repro_torch.analysis import trace_guard    # noqa: F401
from repro_torch.analysis import lint           # noqa: F401
from repro_torch.analysis import liveness       # noqa: F401
from repro_torch.analysis import donation       # noqa: F401
from repro_torch.analysis import baselines      # noqa: F401


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Hot-path audits of the port: ops and host syncs of "
                    "the hot entrypoints, CUDA kernel resources, engine "
                    "syncs per iteration, source lints, liveness, in-place "
                    "updates and the memory-signature ratchet.")
    ap.add_argument("--only", metavar="NAMES",
                    help="comma-separated audit names (default: all)")
    ap.add_argument("--list", action="store_true", dest="list_audits",
                    help="list registered audits and exit")
    ap.add_argument("--memory-report", action="store_true",
                    dest="memory_report",
                    help="print the peak-live-bytes waterfalls and top "
                         "contributors per entrypoint, then exit")
    ap.add_argument("--out", metavar="PATH",
                    help="with --memory-report: also write the report to "
                         "PATH")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"),
                    help="where the entrypoints run (default cpu)")
    args = ap.parse_args(argv)

    if args.list_audits:
        for name in registry.AUDITS:
            print(name)
        return 0
    op_audit.DEVICE = args.device
    import torch
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("[analysis] --device cuda needs a CUDA card",
                  file=sys.stderr)
            return 2
        # the kernel audit reads the ptxas logs of a verbose build: make
        # it before any entrypoint loads the library (nvcc's report goes
        # to build/repro_torch/<source>.log, not to the screen)
        from repro_torch import kernels
        with contextlib.redirect_stdout(io.StringIO()):
            kernels.build(verbose=True)

    if args.memory_report:
        text = liveness.format_memory_report(device=args.device)
        print(text)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text + "\n")
            print(f"[analysis] memory report written to {args.out}")
        return 0

    names = ([n.strip() for n in args.only.split(",") if n.strip()]
             if args.only else None)

    def report(name: str, vs: List[registry.Violation]) -> None:
        status = "ok" if not vs else f"{len(vs)} violation(s)"
        print(f"[analysis] {name:<9} {status}", flush=True)
        for v in vs:
            print(f"  FAIL {v}", flush=True)

    t0 = time.perf_counter()
    try:
        violations = registry.run_audits(names, report)
    except KeyError as e:
        print(f"[analysis] {e}", file=sys.stderr)
        return 2
    dt = time.perf_counter() - t0
    if violations:
        print(f"[analysis] FAILED: {len(violations)} violation(s) in "
              f"{dt:.1f}s")
        return 1
    n = len(registry.AUDITS) if names is None else len(names)
    print(f"[analysis] clean: {n} audit(s) on {args.device} in {dt:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
