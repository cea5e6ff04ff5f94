"""One client a traffic ``entry``: ``clients/<entry>.py`` defines
``Client(cell, llr_pool, devices, slots, overrides)`` with ``issue(p)`` and
``finish(handle, slot)``."""
