"""The program's own counters over the traced frames, for the
``program_counter`` readers of the online cells.

``bpvo_tpu_torch.utils.profiling`` records spans while a profiler session
is on, so the untraced window records none, and the warm-up step of a
traced session none.  The first ``ctx.traced_frames`` ``vo.add_frame``
roots are then the frames of the device-only session's active step; each
is paired with the ``sgm.run`` root before it (the frame's matcher).  A
program without that recorder (no ``profiling.spans``) gives nothing.

The spans' times are not read here: the traced frames run after the
timed window and under the profiler, which slows the host's launches and
copies, so their medians would not be the window's."""
from __future__ import annotations

from typing import List, NamedTuple, Optional


class Frame(NamedTuple):
    """One traced frame: its ``sgm.run`` and ``vo.add_frame`` roots."""
    sgm: object
    add: object

    def counted(self, name: str) -> int:
        """The counter ``name`` over the frame: the ``vo.add_frame`` root's
        end less the ``sgm.run`` root's start."""
        return (self.add.counts1.get(name, 0)
                - self.sgm.counts0.get(name, 0))


def frames(ctx, profiling, who: str) -> Optional[List[Frame]]:
    """The traced frames, or None (logged, naming the metric ``who``) where
    the program records no spans or fewer frames than were traced."""
    read = getattr(profiling, "spans", None)
    n = ctx.traced_frames
    if read is None:
        ctx.log(f"{who}: the program records no spans: not reported")
        return None
    out, sgm = [], None
    for s in sorted(read(), key=lambda s: s.id):
        if s.parent is not None:
            continue
        if s.name == "sgm.run":
            sgm = s
        elif s.name == "vo.add_frame":
            if sgm is None:
                ctx.log(f"{who}: traced frame {len(out)} has no sgm.run "
                        f"root before it: not reported")
                return None
            out.append(Frame(sgm, s))
            sgm = None
            if len(out) == n:
                break
    if not n or len(out) < n:
        ctx.log(f"{who}: {len(out)} vo.add_frame roots recorded, "
                f"{n} frames traced: not reported")
        return None
    return out

