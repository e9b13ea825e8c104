"""server.wait_s: per sample, the sum over the device server's
server.request spans (NW calls and the typing workers' cluster x read
products and pair reductions) of wait_ns, the time from the worker's send
to the start of service: the requests' wait in the server's one-thread
queue.  Mean over the window's samples."""

from hlabench import spans


def read(record):
    return spans.mean_attr(record, "server.request", "wait_ns")
