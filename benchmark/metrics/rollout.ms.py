"""Host ms an iteration spends in whole-chain rollouts (K4): the line
search's lanes, or CEM's population and refit mean."""
from benchmark.readers import ms_per_iteration

SOURCE = "program_span"


def read(run):
    return ms_per_iteration(run, "rollout")
