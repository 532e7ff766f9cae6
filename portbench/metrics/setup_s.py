"""setup_s: seconds from the harness's start to the window's: imports,
the card's context, the traffic, the server, the warm pass and flush."""


def read(run):
    return run["setup_s"]
