"""Device records (kernels, copies, fills) a traced round: a count that
repeats exactly while the program's round does not change."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["records"]:
        return None
    return tr["records"] / tr["rounds"]
