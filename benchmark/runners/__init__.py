"""Runners: the code that runs a traffic mix against the program, one file each."""
