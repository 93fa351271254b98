#!/usr/bin/env bash
# The loader in place on one card: the card-only reuse test, the three
# destinations of the native gather, and the loader alone of a parent
# checkout (unpacked at $PARENT) against this one, in turns P C C P.
#   bash results/torch_loader_in_place/run.sh <out_dir> [parent_dir]
set -euo pipefail
OUT=${1:?out dir}
PARENT=${2:-parent}
mkdir -p "$OUT"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)' | tee -a "$OUT/card.txt"
python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_loader_in_place.py -k card 2>&1 \
    | tee "$OUT/card_test.txt" | tail -n 5
python results/torch_loader_in_place/loader_alone.py destinations --batches 40 --runs 3 --out "$OUT/alone.jsonl"
for who in parent change change parent; do
    if [ "$who" = parent ]; then co=$PARENT; else co=.; fi
    python results/torch_loader_in_place/loader_alone.py loader --checkout "$co" --label "$who" \
        --batches 96 --warm 16 --out "$OUT/alone.jsonl"
done
