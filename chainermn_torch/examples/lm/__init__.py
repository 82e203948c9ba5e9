"""The LM trainer twin (``train_lm``)."""
