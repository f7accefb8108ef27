"""The inputs of each cell, made from ``--seed`` on the card (or the device a
test names): the program and the plain reference are given the same ones.
Nothing here imports the program."""

_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9)


def derive_seed(seed: int, *parts: int) -> int:
    """A 63-bit seed for one draw of a run, from the run's ``--seed`` (any
    whole number, also past 32 bits) and the draw's numbers."""
    x = int(seed) % (1 << 64)
    for p in parts:
        x = (x * _MIX[0] + (int(p) + 1) * _MIX[1]) % (1 << 64)
        x ^= x >> 31
    return x % (1 << 63)
