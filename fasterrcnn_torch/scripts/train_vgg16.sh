#!/bin/sh
# Paper schedule for VGG-16 (reference train_pytorch_vgg16.sh): 10 epochs at
# lr 1e-3 then 4 epochs at 1e-4, resuming weights (never optimizer state).
# f32 remains available via --compute-dtype=float32 appended after this
# script's args (argparse keeps the last of a repeated flag).
set -e
python -m fasterrcnn_torch --train --backbone=vgg16 --load-from=vgg16_caffe.pth \
  --compute-dtype=bfloat16 --batch-size=8 \
  --epochs=10 --learning-rate=1e-3 --save-best-to=vgg16_tmp.pth "$@"
python -m fasterrcnn_torch --train --backbone=vgg16 --load-from=vgg16_tmp.pth \
  --compute-dtype=bfloat16 --batch-size=8 \
  --epochs=4 --learning-rate=1e-4 --save-best-to=vgg16_fasterrcnn.pth "$@"
