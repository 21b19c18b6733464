"""Percent of the roofline of the rollout chains' counted work (every
lane's feedback law, narrow phase and warm PDIP iterations at every knot)
over the device time inside the rollout spans."""
from benchmark import counts
from benchmark.readers import roofline

SOURCE = "device_trace"


def read(run):
    c = run.config
    return roofline(run, "rollout", lambda s: counts.chain_work(
        s["A"], s["T"], c["nq"], s["m"], s["nz"], c["contact_rows"],
        c["qp_iters_ws"], s["aug"], s["rel"]))
