"""The model-parallel seq2seq example twin (``seq2seq``)."""
