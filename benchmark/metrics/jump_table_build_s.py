"""jump_table_build_s: host seconds of ops.jump.build_jump_table in set-up
(host placement, the buckets' scatter, stage 0 and the doubling passes),
synchronised."""


def read(run):
    return run.timers.get("jump_table_build_s")
