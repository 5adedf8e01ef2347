"""The plain reference the benchmark judges the program's outputs by.
It imports neither JAX nor anything of the program."""
