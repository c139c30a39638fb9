#!/bin/bash
# Post-process a finished multi-prompt stylize run
# (python -m avatarcraft_tpu_torch.tools.run_multi_stylize): per prompt,
# orbit renders (the fast sampler), before/after side-by-side GIFs,
# eval_style with all three metric tiers and the sparse style delta.
# The port's twin of the JAX package's tools/postprocess_multi.sh: the
# same arguments, variables and output paths, relative to the repository
# root, through the port's CLI and tools.
# Usage: bash avatarcraft_tpu_torch/tools/postprocess_multi.sh [tag] [prompts...]
#   tag: checkpoint tag, a step number (zero-padded to 4, read as decimal:
#   the root script's printf reads 0600 as octal 0384 and stops at 0800)
#   or "final"
# Env overrides: RUN_DIR (style/toy/multi), RES (256), TRAJ (30),
#   SUFFIX ("": appended to gif/eval/delta names, e.g. "_r5"),
#   PLATFORM (default = the CUDA card; cpu = the CPU), passed on as the
#   render CLI's --use_cuda and each tool's --platform
set -euo pipefail
cd "$(dirname "$0")/../.."

TAG=${1:-final}
case "$TAG" in
  ''|*[!0-9]*) ;;  # a non-numeric tag (e.g. final) is used as it is
  *) TAG=$(printf "%04d" "$((10#$TAG))");;
esac
shift || true
PROMPTS=("${@:-lava emerald porcelain}")
if [ ${#PROMPTS[@]} -eq 1 ]; then read -ra PROMPTS <<< "${PROMPTS[0]}"; fi
RUN_DIR=${RUN_DIR:-style/toy/multi}
RES=${RES:-256}
TRAJ=${TRAJ:-30}
SUFFIX=${SUFFIX:-}
PLATFORM=${PLATFORM:-default}
case "$PLATFORM" in
  default) USE_CUDA=true;;
  cpu) USE_CUDA=false;;
  *) echo "PLATFORM must be default or cpu, not $PLATFORM" >&2; exit 2;;
esac
BARE=multi_bare_${RES}

echo "== bare orbit (left side of the sbs gifs) =="
if [ ! -f demo/canonical_360/${BARE}/${BARE}_body_can_0000.png ]; then
  python3 -m avatarcraft_tpu_torch.cli.render_canonical_cli \
    --weights_path artifacts/canonical/bare_smpl_tpu.pth.tar \
    --sampler fast --grid_path artifacts/canonical/grid.npy \
    --exp_name ${BARE} --render_h $RES --render_w $RES \
    --trajectory_resolution $TRAJ --use_cuda $USE_CUDA
fi

for P in "${PROMPTS[@]}"; do
  CKPT=${RUN_DIR}/multi_${P}_${TAG}.pth.tar
  GRID=${RUN_DIR}/multi_${P}_grid.npy
  echo "== $P: orbit render =="
  python3 -m avatarcraft_tpu_torch.cli.render_canonical_cli --weights_path "$CKPT" \
    --sampler fast --grid_path "$GRID" \
    --exp_name multi_${P}${SUFFIX} --render_h $RES --render_w $RES \
    --trajectory_resolution $TRAJ --use_cuda $USE_CUDA
  echo "== $P: sbs gifs =="
  python3 -m avatarcraft_tpu_torch.tools.make_sbs_gif --left demo/canonical_360/${BARE} \
    --right demo/canonical_360/multi_${P}${SUFFIX} --pattern '*_body_*.png' \
    --out docs/media/multi_${P}${SUFFIX}_sbs.gif
  python3 -m avatarcraft_tpu_torch.tools.make_sbs_gif --left demo/canonical_360/${BARE} \
    --right demo/canonical_360/multi_${P}${SUFFIX} --pattern '*_head_*.png' \
    --out docs/media/multi_${P}${SUFFIX}_head_sbs.gif
  echo "== $P: eval_style (3 tiers) =="
  python3 -m avatarcraft_tpu_torch.tools.eval_style --ckpt "$CKPT" --grid_path "$GRID" \
    --style ${P} --guidance artifacts/toy_guidance \
    --out docs/eval/multi_${P}${SUFFIX}.json --platform $PLATFORM
  echo "== $P: sparse delta =="
  mkdir -p artifacts/styled
  python3 -m avatarcraft_tpu_torch.tools.style_delta pack --base artifacts/canonical/bare_smpl_tpu.pth.tar \
    --styled "$CKPT" --grid "$GRID" --out artifacts/styled/multi_${P}${SUFFIX}_delta.npz --platform $PLATFORM
done
echo "== postprocess done =="
