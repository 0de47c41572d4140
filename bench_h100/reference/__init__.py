"""The plain reference that decides `correct`, and the comparison."""
