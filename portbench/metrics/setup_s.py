"""setup_s: seconds from the start of the process to the start of the
measured window: imports, the device, the kernels' library (built on the
first run of a checkout), weights, inputs and the warm-up of every shape
the traffic uses."""


def read(run):
    return run.setup_s
