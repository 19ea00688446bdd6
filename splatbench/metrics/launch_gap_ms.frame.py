"""Device ms per frame in which the card ran none of the program's work
while the host was launching the graph, from the program's record."""

from splatbench import stages


def read(trace: dict):
    return stages.launch_gap_ms(trace)
