"""Example applications built on the TeShu shuffle layer."""
