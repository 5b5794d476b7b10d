"""Speculation rounds a waiting read took: the native engine's
``sw_fsm_rounds``, the (FSM, wave) pairs that offered SW jobs, over
``sw_fsm_starts``, the FSMs their start left waiting on the card (count
slots of the port's stage timers).  1 means every read found what its
walk applied in its first round."""


def read(obs):
    t = obs["timers"]
    starts = t.get("sw_fsm_starts", [0.0, 0])[1]
    if starts <= 0:
        return None
    return t.get("sw_fsm_rounds", [0.0, 0])[1] / starts
