"""Interop with the JAX package's parameter trees and export format."""
