"""Percent of the roofline of the boxed trajectory QP's counted work (the
unconstrained Riccati solve with its plan, then the ADMM sweeps, at the
augmented state size) over the device time inside the QP's spans."""
from benchmark import counts
from benchmark.readers import roofline

SOURCE = "device_trace"


def read(run):
    return roofline(run, "lqr", lambda s: counts.lqr_work(
        s["T"], s["n"], s["m"], s["sweeps"], s["box_kinds"]))
