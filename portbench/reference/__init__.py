"""The plain reference: a float32 forward of the configurations' dense
decoder in plain PyTorch, from the benchmark's weights, with nothing of
the program."""
