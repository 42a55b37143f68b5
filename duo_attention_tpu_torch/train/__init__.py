"""Gate training (counterpart of duo_attention_tpu/train/): the passkey data,
the losses, the gate trainer and the tiny-LM pretraining."""
