"""Plain references that decide ``correct``: plain PyTorch, no kernel and
no module of the program, fed the inputs the harness made."""
