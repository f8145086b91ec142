"""The plain reference of the benchmark: a float32 PyTorch EGT, its
training steps, the batches it builds from records itself, and the
comparison that decides `correct`. It imports nothing of the program."""
