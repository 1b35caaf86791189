"""Client-error type of the inference paths (port of the part of
``parallel/inference.py`` the serving path needs)."""


class InvalidInputError(ValueError):
    """Request rejected up front (wrong feature shape, bad ids): a
    *client* error, distinguishable from ValueErrors raised inside the
    model forward."""
