"""The mobile_soc cost model's decode energy of the window's decode
steps (each step's ledger delta, ``StepRecord.energy_j``), over the tokens
those steps made, in millijoules.  A modeled number: it describes the
paper's phone SoC, not the card."""


def read(run):
    ks = run.window_decodes()
    n = sum(len(run.decodes[k].slots) for k in ks)
    if n == 0:
        return None
    return sum(run.decodes[k].energy_j for k in ks) / n * 1e3
