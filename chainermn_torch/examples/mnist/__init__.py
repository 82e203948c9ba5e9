"""The MNIST example twins (``train_mnist``, ``train_mnist_checkpoint``,
``train_mnist_model_parallel``)."""
