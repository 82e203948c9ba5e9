"""The channel-parallel convolution example twin
(``train_parallel_conv``)."""
