#!/bin/sh
# ResNet-50 recipe (reference train_pytorch_resnet50.sh): torchvision
# IMAGENET1K_V1 initial weights, same two-phase schedule.
# Export the torchvision state dict first, e.g.:
#   python -c "import torchvision, torch; torch.save(
#     torchvision.models.resnet50(weights='IMAGENET1K_V1').state_dict(),
#     'resnet50_imagenet.pth')"
set -e
python -m fasterrcnn_torch --train --backbone=resnet50 --load-from=resnet50_imagenet.pth \
  --compute-dtype=bfloat16 --batch-size=8 \
  --epochs=10 --learning-rate=1e-3 --save-best-to=resnet50_tmp.pth "$@"
python -m fasterrcnn_torch --train --backbone=resnet50 --load-from=resnet50_tmp.pth \
  --compute-dtype=bfloat16 --batch-size=8 \
  --epochs=4 --learning-rate=1e-4 --save-best-to=resnet50_fasterrcnn.pth "$@"
