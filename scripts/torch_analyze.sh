#!/usr/bin/env bash
# Hot-path audits of the PyTorch port on the CPU (~1 min):
#   python -m repro_torch.analysis — op audits of the hot entrypoints
#   (dispatch buffers, cache repeats, host syncs, kernels reached per
#   switch state), CUDA kernel resources and contracts at every registry
#   config's shapes, the engine's syncs per iteration, source lints,
#   liveness, in-place updates and the memory-signature ratchet against
#   scripts/torch_analysis_baselines.json (src/repro_torch/analysis/).
# REPRO_UPDATE_BASELINES=1 regenerates the baselines before the gate
# (the memory audit then passes by construction — commit the diff).
# Extra args pass through: torch_analyze.sh --only lint, --device cuda.
set -euo pipefail
cd "$(dirname "$0")/.."
if [[ "${REPRO_UPDATE_BASELINES:-0}" == "1" ]]; then
    PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} \
        python scripts/torch_update_baselines.py
fi
PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH} python -m repro_torch.analysis "$@"
