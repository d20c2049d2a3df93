"""What the benchmark's tools share."""


def seed_list(text: str) -> list:
    """'101-104,9' -> [101, 102, 103, 104, 9]."""
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out
