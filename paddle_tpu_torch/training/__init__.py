"""Training helpers shared by the model families (port of
``paddle_tpu/training``; the sentinel loop is not ported yet)."""
