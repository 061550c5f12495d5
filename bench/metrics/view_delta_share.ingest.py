"""Share of the window's view builds that were delta patches: the change
in ``view_delta_patches`` over the change in patches plus full builds."""
from benchlib.record import ratio_pct


def read(run):
    patches, full = run.delta("view_delta_patches"), \
        run.delta("view_full_builds")
    if patches is None or full is None:
        return None
    return ratio_pct(patches, patches + full)
