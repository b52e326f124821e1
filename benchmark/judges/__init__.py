"""Judges, one file each, found by the name a configuration's ``judge``
gives (``style`` where it names none)."""
