"""Set-up seconds: from the process's start (imports included) to the
window's, through input generation, the layout, kernel builds and one warm
solve."""


def read(run):
    return run.setup_s
