#!/usr/bin/env bash
# The chip record of a change to the port, in one call on one CUDA card:
# chip_smoke.py, the card tests, chip_smoke.py --profile,
# tools/attn_variants.py, and chip_smoke.attn_probe and
# chip_smoke.lora_phase (lora_matmul's checks and times at every path's
# shape) on a parent checkout and this one in turns (parent, this, this,
# parent).
#
#   bash tools/chip_final.sh PARENT_DIR OUT_DIR
#
# Run from the root of a checkout on a machine with one CUDA card and
# nvcc.  PARENT_DIR is a checkout of the commit to compare with (for
# example `git archive` of the parent unpacked in a gitignored
# directory); its kernels build into its own tree.  Each step writes its
# own log in OUT_DIR: smoke.log, pytest.log, profile.log, variants.log,
# pairs.log.  The script prints each step's exit code and exits non-zero
# if any step failed.
set -u
if [ $# -ne 2 ] || [ ! -d "$1/src/repro_torch" ]; then
    echo "usage: bash tools/chip_final.sh PARENT_DIR OUT_DIR" >&2
    exit 2
fi
parent=$(cd "$1" && pwd)
out=$2
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
rc=0

step() {
    local name=$1
    shift
    "$@" > "$out/$name.log" 2>&1
    local r=$?
    echo "$name rc=$r"
    [ $r -eq 0 ] || rc=1
}

probe() {
    for tree in "$parent" "$PWD" "$PWD" "$parent"; do
        echo "tree: $tree"
        PYTHONPATH="$tree/src:$PWD" python3 -c '
import torch
import chip_smoke as cs
cs.attn_probe(torch.Generator(device="cuda").manual_seed(0))
cs.lora_phase(torch.Generator(device="cuda").manual_seed(1))' || return 1
    done
}

step smoke python3 chip_smoke.py
step pytest env PYTHONPATH=src python3 -m pytest -q -m cuda \
    -p no:cacheprovider tests/test_torch_cuda.py \
    tests/test_torch_cuda_tape.py tests/test_torch_cuda_llm.py \
    tests/test_torch_cuda_qlora.py tests/test_torch_cuda_sequential.py \
    tests/test_torch_cuda_shots.py tests/test_torch_cuda_fused.py \
    tests/test_torch_cuda_sharding.py
step profile python3 chip_smoke.py --profile
step variants python3 tools/attn_variants.py
step pairs probe
tail -n 3 "$out/smoke.log" | cut -c1-400
tail -n 1 "$out/pytest.log"
exit $rc
