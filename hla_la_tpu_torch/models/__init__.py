"""The port's pipeline layers: subclasses of the reference's aligner and
typer that own only the device seams, and the HLA typing workflow."""
