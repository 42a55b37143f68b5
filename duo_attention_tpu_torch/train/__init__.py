"""Gate-training data (counterpart of duo_attention_tpu/train/). Only the
passkey dataset is ported so far; the trainer comes with the training slice."""
