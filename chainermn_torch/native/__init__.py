"""Native (C++) host components: the batch-assembly loader of the
training input pipeline (:mod:`chainermn_torch.native.dataloader`, the
port of ``chainermn_tpu/native/dataloader.py``). Built with ``g++`` at
first use; the loader falls back to numpy when the build fails, as the
reference does."""
