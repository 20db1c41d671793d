"""The loops that drive a window, one module a kind of traffic, named by
the ``driver`` key of a traffic file. A driver's ``setup(cell)`` returns an
object with ``window(seconds=None, units=None, tag=0)``, ``free()`` and
``check(window)``; see ``portbench/README.md``."""
