"""Sharding of the port over several devices (port of
``repro/distributed``): the serving section of ``sharding.py``, which
splits one engine's heads, experts, FFN columns and SSM lane rows over
the shards of a serving mesh."""
