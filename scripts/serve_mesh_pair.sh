#!/bin/bash
# Serving on a mesh of gloo ranks that share one GPU, two trees in turns
# (A, B, B, A) in one run, so that their times come from one card: the
# serve launcher's llama3.2-1b on (data 2, model 2) by heads and by
# sequence, and hymba-1.5b on (data 1, model 2), each at 4 prompts of 2048
# tokens and 32 greedy steps. Each tree is a checkout's root, e.g. two
# `git archive` outputs unpacked under results/ (gitignored); the first run
# of a tree builds its kernels inside its first prefill.
#
#   bash scripts/serve_mesh_pair.sh results/parent results/change
set -u
a=$1 b=$2
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for tree in "$a" "$b" "$b" "$a"; do
  for case in "llama3.2-1b --world 4 --data 2 --model 2 --kv-partition heads" \
              "llama3.2-1b --world 4 --data 2 --model 2 --kv-partition sequence" \
              "hymba-1.5b --world 2 --model 2"; do
    echo "=== $tree: $case"
    # shellcheck disable=SC2086
    PYTHONPATH=$tree/src timeout 300 python -m repro_torch.launch.serve --arch $case \
      --batch 4 --prompt-len 2048 --gen 32 2>&1 | grep -E "rank [0-9]|world=|Error|error"
  done
done
