"""How full the native pool kept its workers while it pumped a part's
slices, in %: the port's ``pump_pool_busy`` seconds (the pool's threads
inside a slice's pump) over ``pump_pool_cap`` seconds (each
``trav_pump_many`` call's wall times the pool's width, ``-threads``).
None where no call ran on the pool, as in a port without it."""


def read(obs):
    t = obs["timers"]
    cap = t.get("pump_pool_cap", [0.0, 0])[0]
    if cap <= 0:
        return None
    return 100.0 * t.get("pump_pool_busy", [0.0, 0])[0] / cap
