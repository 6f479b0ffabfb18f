"""Control plane: mean host wall of a DYVERSE round in the window's
untraced part."""


def read(rec):
    rounds = rec.untraced(rec.rounds)
    if not rounds:
        return None
    return 1e3 * sum(b - a for a, b in rounds) / len(rounds)
