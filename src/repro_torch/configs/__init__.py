"""Architecture configs carried by the port (see ``base.py``)."""
