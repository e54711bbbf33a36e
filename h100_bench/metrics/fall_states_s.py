"""fall_states_s: set-up's fall-state drop (``generate_fall_states``, 150
sim ticks of every env) between two syncs, in s; tasks without fall states
have none."""


def read(record):
    return record.get("fall_states_s")
