"""One reader per metric, found by the metric's name: ``<name>.py``, or
else ``<prefix>.py`` for the part of the name before its first dot, so that
``launches.py`` reads ``launches.cs`` and any later ``launches.*``.

A reader is ``read(rec)``, where ``rec`` is the run's record (``harness.
Record``); it returns the number, or None where the run holds nothing for
it to read, and the harness then leaves the metric out of the line.
"""
