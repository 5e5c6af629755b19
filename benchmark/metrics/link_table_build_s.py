"""link_table_build_s: host seconds of LinkedWalker.from_records in set-up
(the cuckoo table's host placement, the link pack, the table's and the link
CSR's uploads), synchronised."""


def read(run):
    return run.timers.get("link_table_build_s")
