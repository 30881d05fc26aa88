"""Test package: makes ``tests.conftest`` resolve to this directory."""
