"""Native (C++) host components, each one ``.cc`` built with ``g++`` into
``build/`` at first use and loaded with ``ctypes`` (the port of
``chainermn_tpu/native``, with its own copies of the sources):

- :mod:`chainermn_torch.native.dataloader`: the batch-assembly loader of
  the training input pipeline (``dataloader.cc``);
- :mod:`chainermn_torch.native.jpeg`: the JPEG directory loader
  (``jpeg_loader.cc``, libjpeg decode with fused resize and normalize);
- :mod:`chainermn_torch.native.objstore`: the TCP object-store sidecar
  (``objstore.cc``) behind the communicators' optional object transport.

The loaders fall back to numpy or PIL when their build fails, and say
which path runs; the sidecar is taken only when
``CHAINERMN_TORCH_OBJSTORE`` names a store.
"""
