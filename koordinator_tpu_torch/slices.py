"""What the port does not carry yet, and which slice brings it.

The names follow the slice order of ROADMAP.md.  Every input outside what
the port serves raises ``NotImplementedError`` through ``later``, never a
silently different answer.
"""

EXPLAIN = "the explain slice"


def later(what: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} arrives with {slice_name} of the port (ROADMAP.md)"
    )
