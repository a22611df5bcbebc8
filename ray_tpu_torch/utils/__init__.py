"""Helpers of the port: the fail points of the tests and the card's
peak rates (``accelerator.chip_spec``)."""
