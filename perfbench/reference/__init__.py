"""Plain references that decide `correct`; they import nothing of the
program and take nothing it made."""
