"""The reference runs no rematerialization: these keep the copied modules'
call sites as plain calls."""


def covers(value, which: str) -> bool:
    return False


def recomputing() -> bool:
    return False


def checkpointed(fn, *args):
    return fn(*args)
