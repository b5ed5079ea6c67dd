"""Layer 7: golden memory-signature baselines with ratchet semantics (the
JAX package's ``analysis/baselines.py``).

The liveness layer reduces every memory entrypoint to a four-number
signature — peak live bytes, bytes updated in place, aten op count,
kernel calls — on the CPU at the audit's tiny shapes.  This layer diffs
the signatures at HEAD against the golden copies in
``scripts/torch_analysis_baselines.json`` and fails on drift, in both
directions, as JAX does:

  memory.regression       peak live bytes grew, or bytes updated in place
                          shrank (an in-place write became a copy)
  memory.stale-baseline   peak shrank or in-place bytes grew: an
                          improvement the baseline does not record yet
  memory.signature-drift  the kernel calls changed, or the op count moved
                          more than 10 %: the program changed shape enough
                          that the baseline no longer describes it
  memory.baseline-missing the file or an entry is absent

A gate that only catches regressions lets improvements evaporate
unrecorded, and the next regression hides inside the headroom.  Refresh
with ``python scripts/torch_update_baselines.py`` (or
``REPRO_UPDATE_BASELINES=1 scripts/torch_analyze.sh``) and commit the
diff.  The signatures are the CPU's (torch's CPU kernels); the card's
runs are audited by the other layers, not ratcheted.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List

from repro_torch.analysis import liveness
from repro_torch.analysis.registry import Violation, audit

BASELINE_PATH = (pathlib.Path(__file__).resolve().parents[3]
                 / "scripts" / "torch_analysis_baselines.json")
_REFRESH = ("refresh: python scripts/torch_update_baselines.py (commit the "
            "diff)")
_OPS_DRIFT_FRAC = 0.10
FIELDS = ("peak_live_bytes", "inplace_bytes", "ops", "kernel_calls")


def compute_signatures() -> Dict[str, Dict[str, int]]:
    """Signature per memory entrypoint on the CPU (the memoized runs)."""
    return {name: {f: getattr(rep.signature, f) for f in FIELDS}
            for name, rep in liveness.all_reports("cpu").items()}


def load_baselines(path: pathlib.Path = BASELINE_PATH
                   ) -> Dict[str, Dict[str, int]]:
    return json.loads(path.read_text())["entries"]


def diff_signatures(current: Dict[str, Dict[str, int]],
                    golden: Dict[str, Dict[str, int]]) -> List[Violation]:
    """Pure ratchet of the signatures at HEAD against the golden copies
    (separate from running, so tests inject synthetic drift)."""
    out: List[Violation] = []
    for name in sorted(set(current) | set(golden)):
        if name not in golden:
            out.append(Violation(
                "memory.baseline-missing", name,
                f"entrypoint has no golden signature — {_REFRESH}"))
            continue
        if name not in current:
            out.append(Violation(
                "memory.baseline-missing", name,
                "golden signature exists but the entrypoint is no longer "
                f"registered — {_REFRESH}"))
            continue
        cur, gold = current[name], golden[name]
        pc, pg = cur["peak_live_bytes"], gold["peak_live_bytes"]
        if pc > pg:
            out.append(Violation(
                "memory.regression", name,
                f"peak live bytes {pg:,} -> {pc:,} (+{pc - pg:,}) — the "
                "live set grew"))
        elif pc < pg:
            out.append(Violation(
                "memory.stale-baseline", name,
                f"peak live bytes {pg:,} -> {pc:,} (-{pg - pc:,}) — "
                f"improvement; {_REFRESH}"))
        ic, ig = cur["inplace_bytes"], gold["inplace_bytes"]
        if ic < ig:
            out.append(Violation(
                "memory.regression", name,
                f"bytes updated in place {ig:,} -> {ic:,} — an in-place "
                "write was lost (the storage now counts twice)"))
        elif ic > ig:
            out.append(Violation(
                "memory.stale-baseline", name,
                f"bytes updated in place {ig:,} -> {ic:,} — more in place; "
                f"{_REFRESH}"))
        kc, kg = cur["kernel_calls"], gold["kernel_calls"]
        if kc != kg:
            out.append(Violation(
                "memory.signature-drift", name,
                f"kernel calls {kg} -> {kc} — a kernel call was added or "
                f"dropped; {_REFRESH}"))
        oc, og = cur["ops"], gold["ops"]
        if abs(oc - og) > _OPS_DRIFT_FRAC * og:
            out.append(Violation(
                "memory.signature-drift", name,
                f"op count {og} -> {oc} (more than ±"
                f"{_OPS_DRIFT_FRAC:.0%}) — program shape changed; "
                f"{_REFRESH}"))
    return out


@audit("memory")
def _memory_audit() -> List[Violation]:
    if not BASELINE_PATH.exists():
        return [Violation("memory.baseline-missing", str(BASELINE_PATH),
                          f"golden baseline file not found — {_REFRESH}")]
    return diff_signatures(compute_signatures(), load_baselines())
