"""Drivers: how a traffic mix drives the program.  A mix names its driver
(``"driver"``); ``drivers/<name>.py`` holds a ``Driver`` with
``setup()``, ``window(seconds)``, ``traced()``, ``check_inputs()`` and
``free()`` (see ``base.Driver``)."""
