"""Host time a train step waits for its batch: the benchmark's span around
``next()`` on the port's ``data_iterator`` (native loader, prefetch
thread, host-to-device copy), averaged over every step of the window."""
UNIT = "ms/step"


def read(run):
    if run.get("kind") != "train" or not run.get("loader_wait_s"):
        return None
    return 1e3 * sum(run["loader_wait_s"]) / len(run["loader_wait_s"])
