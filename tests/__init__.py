"""Test suite; a regular package so ``tests.golden`` imports ahead of any
other top-level ``tests`` package installed on the machine."""
