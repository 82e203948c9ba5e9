"""The ImageNet trainer twin (``train_imagenet``)."""
