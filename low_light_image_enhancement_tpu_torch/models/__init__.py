"""The curve CNN, its conv primitive and the shipped weights."""
