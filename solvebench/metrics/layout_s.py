"""Host seconds of the set-up's layout call (``try_dia_from_csr`` or
``best_format``), synchronised at both ends."""


def read(run):
    return run.layout_s
