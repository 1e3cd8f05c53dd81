"""The loops that drive the program, one a kind of job (``<loop>.py``)."""
