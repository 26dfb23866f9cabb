"""Seconds from the process's start to the end of set-up: import, kernel
load (a build in a fresh checkout), weights, tokens, the engine's state
and the first rounds that the reference follows."""


def read(run):
    return run["setup_s"]
