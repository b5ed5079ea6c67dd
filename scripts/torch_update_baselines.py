#!/usr/bin/env python
"""Regenerate scripts/torch_analysis_baselines.json from the memory
signatures of the port at HEAD (on the CPU).

The ``memory`` audit (src/repro_torch/analysis/baselines.py) ratchets
every memory entrypoint's signature — peak live bytes, bytes updated in
place, aten op count, kernel calls — against this file, failing on
regressions and on unrecorded improvements alike.  When it reports
``memory.stale-baseline`` (or an entrypoint changed on purpose), run this
script and commit the diff.  ``REPRO_UPDATE_BASELINES=1
scripts/torch_analyze.sh`` does the same before the gate runs.
"""
from __future__ import annotations

import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

from repro_torch.analysis import baselines  # noqa: E402


def main() -> int:
    torch.set_num_threads(1)
    entries = baselines.compute_signatures()
    old = {}
    if baselines.BASELINE_PATH.exists():
        old = baselines.load_baselines()
    doc = {
        "note": "golden memory signatures per analysis entrypoint of the "
                "port, on the CPU; regenerate with "
                "scripts/torch_update_baselines.py and commit the diff "
                "(the memory audit ratchets against this file)",
        "entries": {name: entries[name] for name in sorted(entries)},
    }
    baselines.BASELINE_PATH.write_text(
        json.dumps(doc, indent=2, sort_keys=False) + "\n")
    for name in sorted(entries):
        sig = entries[name]
        mark = " " if old.get(name) == sig else "*"
        print(f"{mark} {name:<34} peak {sig['peak_live_bytes']:>12,} B  "
              f"in place {sig['inplace_bytes']:>10,} B  "
              f"ops {sig['ops']:>5}  kernel calls {sig['kernel_calls']}")
    for name in sorted(set(old) - set(entries)):
        print(f"- {name} (removed)")
    print(f"wrote {baselines.BASELINE_PATH.relative_to(REPO)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
