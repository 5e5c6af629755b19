"""tesserae_host_route_share: the share of the window spent in sections that
the aligner's budget gate sent to its host oracle (the aligner's own
`host_sections` counter tells them apart), in percent."""


def read(run):
    if not run.counts.get("sections"):
        return None
    return 100.0 * run.counts.get("host_section_s", 0.0) / run.window_s
